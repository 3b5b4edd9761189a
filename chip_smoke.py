#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_nn_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one NVIDIA GPU (Hopper: the kernels are built for ``sm_90a``),
``nvcc`` and ``nvidia-smi``, and imports nothing of JAX or of the JAX
package. Phases, each fatal on failure (exit 1, no result line):

1. Build every CUDA kernel from ``tpu_dist_nn_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and print the build time and
   ptxas' register and shared-memory report.
2. Hold each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a few more, with the stated tolerances
   (TF32 off for every float32 comparison). The f32 dense kernels also
   at the conv network's 2048-64-10 tail (split-K across a cluster, at
   1024, 1023 and 37 rows, uint8 input, a ragged K of 2000), with a
   softmax normalised in the epilogue and in a second pass, and each
   called twice on one input: bit-equal. The int8 tensor-core chain at
   8192, 8191 and 37 rows, 1024-1024-1024-10, a 60000-wide input and
   (cut in two) a 60000-wide interior, bit-equal on a repeat; the conv
   implicit GEMM at batch 1023, an odd 31x29 image with overlapping 3x3
   stride-2 windows, stride 2 VALID, softmax over the channels, and the
   two shapes a band planner refused ((1, 64, 64, 256) x 3x3x256x256 and
   (1, 3, 32, 1024) x 3x3x1024x1). Each flash backward twice on one
   input at the 85M shape (B 16, H 12, T 1024, Dh 64) and at Dh 32 and
   128: dq, dk and dv bit-equal; the sm90 pair also at the
   model-parallel shard's shape (B 4, H 6) and at Ulysses' shapes (B 16
   and B 4, H 3). F9: NaN in three input rows
   of the relu dense layer, the f32 chains, the int8 chains and four
   relu conv stages (pooled in registers, from the tile, unpooled):
   those rows non-finite in the kernel's output as in the plain
   version's, every other row bit-equal to the clean input's and within
   tolerance of the plain version (the relu/linear int8 chain
   bit-equal).
3. Drive each main path with every kernel's launch count set to 0
   just before it and read just after:

   * the dense path: a seeded MNIST-width FCNN (784-128-64-10) written
     in the reference JSON schema, ``Engine.up(path, [1, 1, 1])`` and
     ``run_inference`` over 60,000 seeded rows at batch 8192, once in
     float32 and once with ``quantize="int8"``; the CLI's ``infer`` on
     a 256-row examples file; and the CLI's ``doctor`` kernel probe.
     The float32 outputs must match the float64 oracle and the int8
     outputs the plain int8 chain; uint8 rows through the f32 engine
     must be bit-equal to the same rows cast to float32.
   * the layer pipeline path (``pipeline_phase``): ``Engine.up(path,
     [1, 1, 1], devices=[card] * 3)`` (three stage slots, one CUDA
     stream each) at 4 microbatches, ``run_inference`` over the 60,000
     rows at batch 8192 in f32 and int8, in turns with the single
     program: the chain (int8 chain) launching stages x microbatches
     times a batch, f32 within 1e-5 of the float64 oracle, int8
     bit-equal to the single-program int8 engine; each stage's launch
     at 2,048 rows timed beside the whole chain at 8,192; 20 runs of one
     batch in flight together under allocator churn, bit-equal;
     ``step_latency`` at batch 256; the 34-layer model on ``[9, 9, 8,
     8]`` at ``virtual_stages=2`` (f32 within 1e-5 of its single
     program and the oracle, int8 bit-equal); the digits record's recipe
     trained through ``[1, 1, 1]`` with ``schedule="1f1b"`` (held-out
     >= 0.97, the exported model at the same accuracy on one program);
     gpipe and 1f1b first-step losses and gradients (the CPU tests'
     tolerances) and one 60,000-row epoch of each beside one program.
     Compiled steps (CUDA graphs): the pipelined forward of 256 rows
     graphed against eager (p50, bit-equal); the gpipe, 1f1b and
     interleaved training steps at batch 64, eager and graphed in turns
     over 150 steps, ms/step and samples/s beside BASELINE's 10,000,
     weights, Adam state and losses bit-equal; and BASELINE
     ``configs[2]`` (``artifacts/deep_pipeline_r04/RECORD.json``:
     64-96-80-64-48-32-24-16-10 on ``[1] * 8``, 30 digits epochs) on
     eight stage slots of the card, held-out >= 0.97.
   * the train path (native FCNN training), with ``TDN_INT8_AUTO=0``
     for every int8 check but the gate's: the digits record's command
     (``cli train --data digits --layers 64,128,64,10 --epochs 40
     --lr-schedule cosine --warmup-steps 50 --out``) in a subprocess,
     held-out accuracy and F1 >= 0.97 (record 0.9805 / 0.9805), and the
     CLI's ``infer`` of the exported model on the 359 held-out digits at
     exactly the trainer's accuracy; 784-128-64-10 over 60,000 seeded
     ``synthetic_mnist`` rows at batch 64 for 3 epochs through
     ``Engine.up`` + ``Engine.train`` with eval on 10,000 more each
     epoch: the mean loss falls every epoch, no kernel launches in the
     steps and one chain launch per eval batch, ms/step and samples/s
     printed; 1 epoch plus a checkpoint resume to 3 equals the straight
     3 (atol 1e-7, rtol 1e-6); 2 digits epochs on the card and on the
     CPU from one init (losses within rtol 1e-4); a trained int8 engine
     bit-equal to the plain int8 chain on its re-quantized weights; the
     FCNN step eager and graphed in turns over 150 steps (ms/step,
     samples/s, bit-equal); and the int8 warm-up gate with
     ``TDN_INT8_AUTO`` unset at 64 rows (``up --grpc-port``'s warm
     ladder) and 8,192: its ratio (CUDA-event device times) and decision
     beside the chain kernels' own event times (a decision against a
     kernel ratio past 1 +- 0.10 fails), and launches that follow it.
   * the Process path (the reference's ``LayerService.Process`` RPC):
     the 60,000 rows encoded as float64 ``Matrix`` requests of 1, 7,
     64, 512 and 4,096 rows in turn, sent from 10 threads through the
     handler body (``make_process_handler``) and the coalescing
     ``Batcher`` (depth 2) in front of ``Engine.up(path)``: replies
     within 1e-5 of the float64 oracle and bit-equal to
     ``Engine.infer`` on each request's rows alone, one chain launch per
     batch and fewer batches than requests; again at depth 1 (bit-equal
     to depth 2) with one wrong-width request refused INVALID_ARGUMENT
     among them; the int8 engine (bit-equal to its rows alone, the
     plain int8 chain within its tolerance); 1,024 CIFAR rows through
     the conv engine (CONV_TOL of the plain versions). Where grpcio is
     installed, the same over loopback gRPC (``serve_engine``,
     ``GrpcClient``), the CLI's ``up --grpc-port 0`` in a subprocess
     with ``infer --target`` (its accuracy line equal to the local
     ``infer``'s), five more ``up --grpc-port`` servers at once (one
     int8 with its gate on), each SIGTERMed after answering a request,
     every return code 0, and ``python3 -m tpu_dist_nn_torch.bench
     --serving``; without grpcio it prints ``grpc: not installed;
     socket phase not run``. Then each stage's median time from the
     trace spans (decode, queue_wait, stage, launch, fetch, encode),
     the wall time of a request by size, the chain kernel's device time
     for the same batches, and the headline bench line
     (``python3 -m tpu_dist_nn_torch.bench``).
   * the numeric guard on the Process path (``guard_phase``, F8's
     repair): 8 requests of 7 rows, one with a NaN row, queued behind
     an 8,192-row request and coalesced into one chain launch of the
     relu MNIST model (its NaN kept by the kernel since F9's repair;
     the chain kernel alone gives that row non-finite, the others
     finite): the poisoned request fails
     ``DATA_LOSS`` alone, its neighbours bit-equal to their solo
     replies, two chain launches; ``Engine.infer`` on the poisoned rows
     raises ``IntegrityError``; then the Process path's 60,000 rows
     with the guard armed and disarmed in turns (rows/s each, printed),
     and the guard's own time in the armed passes (host clock, beside
     the pass's wall, printed).
   * the conv train path (``conv_train_phase``, after the Process
     path): BASELINE ``configs[3]``'s network at full width
     (``init_conv_mlp``'s defaults, seeded) on ``tdn train``'s
     synthetic rows and defaults (12,000 rows split 0.9, 5 epochs,
     batch 64, Adam 1e-3): ``cli train --config conv.json`` single
     program (per-epoch losses and seconds, held-out accuracy, the loss
     falling every epoch), ``cli infer`` of its export at the same
     accuracy; the conv step eager and graphed in turns (weights, Adam
     state and losses bit-equal); then the heterogeneous pipeline on
     ``[2, 2, 2]`` over three slots of the card, 4 microbatches: its
     first-step loss and gradients against the single program (the
     pipeline tests' tolerances, with the process's cuDNN flags at
     PyTorch's defaults, so each step must set its own), ``Engine.train``
     with eval over the recipe's 5 epochs (no launch in the steps, 2
     conv and 1 chain launches an eval, the loss falling every epoch;
     its per-epoch losses and final weights against the CLI's run are
     printed, not held: the two trajectories drift apart), per-step
     losses over 16 steps with and without ``clip_norm`` 0.05 within
     rtol 1e-4 of the single program, the hetero gradients from the
     single program's weights at each of those 16 steps, then
     ``train_hetero`` cut after epoch 2 and resumed (rtol 1e-5 / atol
     1e-7 of the 5-epoch run), its step eager and graphed (bit-equal), the forward of 10,000 rows at batch 1024 beside the
     single-program engine (2 conv and 1 chain launches a microbatch;
     bit-equal, or within 1e-5 of the float64 oracle) and
     ``measure_dispatch_overlap``.
   * the conv path: the CIFAR-10 conv+MLP network (``init_conv_mlp``'s
     defaults, 32x32x3 -> conv16+pool -> conv32+pool -> 64 -> 10),
     ``Engine.up(path, [2, 2, 2])`` and ``run_inference`` over 10,000
     seeded rows at batch 1024 (two conv launches and one chain launch
     per batch), held against the float64 oracle on 128 rows; and the
     CLI's ``infer`` on a 256-row examples file.

   * the LM training path: the 86,039,040-parameter byte-level
     Transformer (d 768, 12 heads, 12 layers, d_ff 3072, T 1024,
     batch 16, bf16 over float32 masters, remat; Adam at 3e-4, cosine
     after 5 warm-up steps) trained for 30 steps on the vendored
     corpus through ``train_lm``, then ``evaluate_lm`` on 8 held-out
     batches. bf16 attention routes to the sm90 tensor-core kernels:
     ``flash_fwd_sm90`` must launch exactly steps x 12 x 2 (remat) + 12
     per eval batch times, ``flash_bwd_sm90`` steps x 12, the f32
     flash kernels never; every loss finite and the last below the
     first. Before it, the same width at depth 2 (batch 4) trains 3
     steps with the flash kernels and with the materialised
     ``dot_product_attention``: in float32 (the f32 route, its own
     path for the launch counts) first loss within rtol 1e-5, all three
     within 1e-4, first-step gradients within 5e-4; in bf16 (the sm90
     route) first loss within rtol 1e-3, all three within 1e-2.
     Every ``train_lm`` step here is a captured CUDA graph. After it,
     the same recipe's step eager (8 steps) and as 4-step supersteps
     (``steps_per_call=4``, its first 16 steps; losses bit-equal to one
     step a call): s/step and tokens/s of each; then the CLI's
     ``lm`` verb runs 4 steps with ``--steps-per-call 2``.

   * the generation path (``generate_phase``, after the supersteps),
     on the params the 85M path trained, in bf16: ``generate`` greedy at
     batch 16, 128-byte held-out prompts, 512 new tokens (a 639-position
     cache), the decode step eager and as its replayed CUDA graph in
     turns (a warm-up of each, then 2 each): every run's tokens
     bit-equal, ms/step and tokens/s of each arm, the start (params
     cast, prefill, first sample) and the prefill alone (CUDA events,
     medians), beside the step's bound (weight and K/V bytes); at
     depth 2 in float32 (TF32 off) greedy tokens against the
     teacher-forced argmax for 64 tokens (a divergence fails unless its
     top-2 logit gap is at most 1e-3); ``decode_step_slots`` at one
     position bit-equal to ``decode_step``, and
     ``prefill_chunk_into_cache`` split 40 + 88 and after a copied
     64-token prefix bit-equal to ``prefill_into_cache``; sampling at
     temperature 0.8, top-k 40, top-p 0.9: every draw inside its
     truncated set (stepped through the cache eagerly), a seed repeats,
     a generator's second call differs; ``tdn lm``'s float32 recipe
     with ``--checkpoint-dir --sample-bytes 64`` straight, and cut at
     step 200 (asynchronous saves) then resumed: held-out within 0.01
     nats; one asynchronous save of the 85M training state (params,
     Adam's mu and nu): the time the step waits for its host snapshot,
     and a bit-exact restore.

   * LM serving (``serving_phase``, after the generation path), on the
     85M LM in bf16 with seeded init params whose query and key
     projections are drawn at twice the scale (the 30-step params emit
     spaces whatever the prompt, the plain init one repeated byte a
     prompt). First a probe: every load prompt through a scheduler
     without eos or prefix cache; more than half of the continuations'
     first 16 tokens must differ, and ``pick_eos`` picks from them an
     eos that ends some requests and not others. Then
     ``serve_lm_generate`` with the continuous scheduler (16 slots,
     128-byte held-out prompts, 256 new tokens, that eos, prefill chunks
     of 64, 4 prefix blocks) on a loopback port, 32 handler threads.
     The load: 24 requests from 12 threads (12 share a 64-byte header),
     every other one a ``Generate`` RPC, the rest submitted with budgets
     of 16 to 255 tokens; some must retire on eos and some on their
     budgets. Then 4 ``best_effort`` ``GenerateStream`` requests bind
     first, the 12 longest other load requests fill the other slots,
     and 4 ``critical`` requests are sent while every slot is busy and
     the streams decode, so preemption evicts the streams and they
     resume by forced-token replay. Each load request alone on the
     scheduler is the reference. Checks: (a) each reply (load, the 12,
     the critical) bit-equal to its prompt's run alone; (b) every
     emitted token's logit within 0.25 of the full forward's max (bf16,
     materialised attention); (c) the preempted streams equal their
     unpreempted runs; (d) the probe (prefix cache off) bit-equal to
     the load (on) up to eos; (e) each stream's tokens equal its unary
     reply, each once; (f) the captured step bit-equal to the eager
     step (tokens, ok mask, cache) at staggered positions with an
     inactive slot; (g) a NaN forced into one slot's cache through
     ``fetch_hook`` fails that request alone ``DATA_LOSS``. Printed:
     TTFT p50 / p99, tokens/s, slot occupancy, prefill chunks, prefix
     hits / misses / evictions, preemptions, the step graphed and eager
     (ms/step), a prefill chunk's ms, and the static arm's tokens/s
     (within the budgets) and latency on the same 24 prompts.
   * the model-parallel LM (``model_parallel_phase``, after LM
     serving): BASELINE ``configs[4]``'s per-block pipeline with the
     Megatron split, the 85M LM in bf16 with remat on stage x model
     slots of the card (cut from a multi-chip mesh). The first step's
     loss and gradients of gpipe, 1f1b and zb at stage 4 x model 2, of
     interleaved at 2 stages x 3 virtual x 2 model, of zb-v at 3 stages
     x 2 model and of zb-stash at stage 4 (4 microbatches each) against
     the single bf16 program run over the same 4 microbatches
     (gradients summed, as the pipeline sums them), within 4 times that
     reference's own spread a leaf (flash against the materialised
     attention; at least 2**-8; the loss at least within 1e-3), and
     gpipe against 1f1b at tests/test_pipeline_1f1b.py's tolerance; 4
     steps each of the six schedules: finite, falling losses, each
     step's loss within that loss tolerance of the single program's at
     the same step, step p50 by CUDA events beside the eager single
     program's, and one step's launches exactly the sm90 flash pair at
     the counts its backward implies (192 forwards and 96 backwards for
     the combined backward: 12 blocks x 4 microbatches x 2 model slots,
     remat; 264 and 168 for zb, 272 and 176 for zb-v, 96 and 48 for
     zb-stash, none inside its W ops); the same 4 steps graphed through
     ``train_lm`` (the step captured on the card's slots) bit-equal to
     the eager ones, losses and trained params, step p50 graphed and
     eager beside the graphed single program's. Decode on seeded init
     params with q and k x 2: the overlapped pipelined decoder at 4
     stages x 4 groups of 4 rows (128-byte prompts, 32 greedy tokens)
     equal to ``generate`` of each group; ``tp_generate`` at model 2
     equal, or first differing at a near tie of the reference (top-2
     logit gap under 0.25, each printed);
     ``serve_lm_generate(num_stages=4)`` answering 8 ``Generate``
     requests from 4 threads with the overlapped decoder's tokens; the
     tokens/s of each decoder.
   * sequence parallelism (``seq_parallel_phase``, after the
     model-parallel phase): the 85M LM on rows of 1,024 tokens, ring and
     Ulysses attention over seq slots of the card. The first step's loss
     and gradients of sp alone (seq 4 ring and ulysses, seq 2 x data 2
     ring), pp x sp (stage 4 x seq 2 gpipe-ring, 1f1b-ring,
     1f1b-ulysses, zb-ulysses; interleaved 2 x 3 x seq 2 ring; zb-v 3 x
     seq 2 ulysses) and pp x tp x sp (stage 4 x model 2 x seq 2, 1f1b,
     ring and ulysses) against the single bf16 program's masked CE on
     the same rows run over the arm's partition (row groups, and seq
     shards as position chunks, each embedded through its own bf16 copy
     of the table) at the model-parallel phase's limits; each arm's
     launches exactly the sm90
     pair's count (Ulysses: 2 forwards and 1 backward a block,
     microbatch, seq slot and model slot; zb 3 and 2) or none (the
     ring), with SDPA replaced by a raise; the ring's two rotate modes
     bit-equal; 4 steps of sp seq 4 ulysses and ring, pp x sp 1f1b-ring
     and pp x tp x sp 1f1b-ulysses eager and graphed through
     ``train_lm``: finite, falling losses, graphed bit-equal to eager,
     step p50, tokens/s and peak memory beside the graphed single
     program's.

   * the mixture-of-experts LM (``moe_phase``, after sequence
     parallelism): the 85M width with 8 experts, top-2, capacity 1.25
     (README's ``--experts 8 --router-top-k 2``), bf16, remat, seeded,
     batch 16 x 1,024, on slots of the card; 4 microbatches of 4 rows
     where it pipelines. Arms: the single program, flat EP at expert 2 x
     data 2, TP inside the experts at expert 2 x model 2, sp x ep at seq 2
     x expert 2 (ring and Ulysses), pp x ep at stage 4 x expert 2 (gpipe,
     1f1b, zb), interleaved 2 x 3 x 2, zb-v 3 x 2, and pp x sp x ep
     (Ulysses, gpipe) at 2 x 2 x 2. Each arm's first step against the
     grouped single bf16 program over the same routing groups, run over
     its partition, at the model-parallel phase's limits; its routes
     layer by layer against the reference's (a differing route only at a
     near tie, counted and printed); its flash launches the dense
     partition's (SDPA replaced by a raise); a run with one shard routing
     the wrong group must fail the check. The single program, flat EP, sp
     x ep Ulysses and pp x ep 1f1b take 4 steps eager and graphed through
     ``train_lm`` (bit-equal), the other arms 2 eager steps; each arm's
     step p50, tokens/s and peak memory beside the single program's.

   * data parallelism and sharded optimizer state
     (``data_parallel_phase``, after the MoE phase), on 4 data slots of
     the card: the data-sharded engine (``Engine.up(..., data_parallel=
     4)``) serving the MNIST FCNN's 60,000 rows at batch 8,192 in f32
     (every row within 1e-5 of the float64 oracle's arithmetic and
     bit-equal to the single-program engine) and int8 (bit-equal to the
     single-program int8 engine) and the CIFAR conv+MLP's 10,000 rows (the
     single-program engine, ``CONV_TOL``), each with a pad-tail batch,
     every slot launching each kernel once a batch on its own stream,
     samples/s beside the single program's; the FCNN through
     ``Engine.train`` on the slots: step 1's gradients against the single
     program's, the step eager and graphed (bit-equal, ms/step beside the
     single program's), the digits recipe at the digits bar; and the 85M
     LM's ZeRO-1 and FSDP at data 4 and sp x ZeRO-1 (Ulysses) and sp x
     FSDP (ring) at seq 2 x data 2 with ``clip_norm`` on: step 1 against
     the single bf16 program over the arm's partition (its loss and
     Adam's first moment against the clipped reference gradient; a
     per-slice clip must fail), each slot owning exactly 1/N of every
     sliced leaf, the flash launches of the dense partition, 6 steps
     eager and graphed (bit-equal) with step p50, tokens/s and peak
     memory beside the graphed single program's.

   * the float32 LM path, ``tdn lm``'s default recipe
     (``artifacts/real_text_r04/RECORD.json``): d 128, 4 heads, 4
     layers, T 128, batch 16, 400 steps, Adam at 1e-3 cosine after 20
     warm-up steps, seed 0, float32, on the vendored
     ``licenses_corpus.txt`` read by path, through ``train_lm`` and
     ``evaluate_lm`` on the whole held-out split. Attention takes the
     3xTF32 kernels only (``flash_fwd_f32`` steps x 4 + 4 per eval
     batch launches, ``flash_bwd_f32`` steps x 4, sm90 never); every
     loss finite, the last below the first, held-out loss within 0.10
     nats of the record's 2.5303 (the port's weights come from a
     ``torch.Generator``, its batches are the JAX package's); then its
     step eager (100 steps) and as 8-step supersteps (all 400; losses
     bit-equal to one step a call).

   * dense runs past one chain launch, each engine's counts zeroed
     before its run: a 34-layer 16-wide FCNN in float32 (float64
     oracle, 1e-5) and int8 (the plain chain), 784-4000-10 and
     64-8192-10 in float32 (every row against the oracle's arithmetic
     batched in float64, which matches the per-row oracle on 16 rows
     within 1e-10), 60000-16-10 and 64-60000-10 in
     int8 (plain chain); each prints its cut and its chain launches a
     batch.

   Every kernel of a path must have launched in that path's run.
4. Time each kernel, its plain version and the nearest PyTorch library
   call with CUDA events at the main paths' shapes (the chain also at
   the conv tail's; the f32 dense kernels as a CUDA graph of 50 calls,
   since their device time is below a Python call's), beside the least
   time the card could take (its bound); the conv engine's samples/s
   and batch latency (the int8 chain and each conv stage by a host
   loop of 50 calls, or by a CUDA graph of 50 calls where the loop
   takes over 10% longer, both printed); the sm90 flash pair in bf16
   and the f32 pair in float32 beside SDPA in the same dtype, at the
   85M shape and (f32) at the recipe's (B 16, H 4, T 128, Dh 32), with
   the FP32 FFMA and the 3xTF32 bounds printed for the f32 pair, and the
   sm90 pair at the model-parallel, sequence-parallel and MoE arms'
   shard shapes; flash
   attention and the materialised attention at the TPU kernel sweep's
   shape (B 4, H 8, T 4096).

The second-to-last line is one JSON object with a record per kernel;
the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MNIST = [784, 128, 64, 10]
ACTS = ["relu", "relu", "softmax"]
BATCH = 8192
ROWS = 60000
CIFAR_BATCH = 1024
CIFAR_ROWS = 10000  # the size of CIFAR-10's test split
CONV_TOL = (1e-5, 2e-5)  # atol, rtol: tests/test_conv_kernel.py's
DENSE_PATH_KERNELS = ("fused_dense", "fcnn_fused_forward", "fcnn_quantized_forward")
CONV_PATH_KERNELS = ("fused_conv2d", "fcnn_fused_forward")
# The LM main path: the 85M recipe of artifacts/tpu_scale_r04/RECORD.json
# ("run_85m"), cut to 30 steps with 5 warm-up steps.
LM = dict(d_model=768, heads=12, layers=12, seq_len=1024, batch=16, steps=30, warmup=5,
          lr=3e-4, eval_batches=8, params=86_039_040)
# The float32 LM main path: tdn lm's default recipe of
# artifacts/real_text_r04/RECORD.json, in full, and the record's held-out
# results; the held-out loss must land within `band` nats of the record's.
RECIPE = dict(d_model=128, heads=4, layers=4, seq_len=128, batch=16, steps=400, warmup=20,
              lr=1e-3, seed=0, corpus="tpu_dist_nn/data/corpus/licenses_corpus.txt",
              loss=2.5303, perplexity=12.5567, bits_per_byte=3.6504, band=0.10)
RECIPE_K = 8  # the recipe's steps_per_call in its superstep run
FLASH_TOL = (2e-5, 2e-5)  # atol, rtol: tests/test_flash_attention.py's forward
FLASH_GRAD_TOL = (2e-4, 2e-4)  # and gradients
# A bf16 output is its float32 value rounded to nearest even: at most
# 2**-8 of it away. bf16 kernels are held against the plain version run
# in float32 on the same bf16 inputs with that much more rtol. The sm90
# kernels also round P (forward, dV) and dS (dK, dQ) to bf16 for the
# tensor cores: each rounded term moves by at most 2**-8 of its size, so
# their tolerance adds, element by element, 2**-8 of the same product
# over absolute values (kernels.flash_attention.bf16_rounding_bounds).
BF16_RTOL = 2.0**-8
# bf16 training parity, sm90 flash vs dot_product_attention (relative
# loss difference): the two round at different places (the reference
# rounds its scores and each product's output, the kernels P and O), so
# per-token logits differ by about one bf16 rounding (2**-8 = 3.9e-3);
# the loss, a mean over 4,096 tokens, moves by well under one rounding
# at the first step, and Adam's sign-like first updates can carry the
# difference to a few roundings by the third.
BF16_PARITY_RTOL = (1e-3, 1e-2)  # first step, all three

# Published dense peaks (NVIDIA data sheets): device memory bytes/s,
# FP32 FLOP/s on CUDA cores, INT8 tensor-core OP/s, BF16 and TF32
# tensor-core FLOP/s. Matched on the name torch reports; the SXM part is
# the default.
PEAKS = {
    "PCIe": (2.0e12, 51e12, 1513e12, 756e12, 378e12),
    "NVL": (3.9e12, 60e12, 1671e12, 835e12, 417.5e12),
    "SXM": (3.35e12, 67e12, 1979e12, 989e12, 495e12),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks_for(name: str) -> tuple[str, tuple[float, float, float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def bound_ms(nbytes: float, ops: float, ops_rate: float, mem_rate: float):
    t_mem, t_ops = nbytes / mem_rate, ops / ops_rate
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def dense_f64(model, x):
    """The float64 oracle's arithmetic for a dense model, a whole batch
    at once: ``act(a @ W + b)`` a layer in float64, a softmax layer's
    over each row (the per-row oracle forwards one row at a time, too
    slow for tens of thousands of rows or thousands of neurons)."""
    import numpy as np

    from tpu_dist_nn_torch.testing.oracle import _SCALAR_ACTIVATIONS, _np_softmax

    a = np.asarray(x, dtype=np.float64)
    for layer in model.layers:
        z = a @ np.asarray(layer.weights, np.float64) + np.asarray(layer.biases, np.float64)
        act = layer.activation.lower()
        a = _np_softmax(z) if act == "softmax" else _SCALAR_ACTIVATIONS.get(act, lambda v: v)(z)
    return a


def causal_pairs(T: int) -> int:
    """(query, key) pairs a causal head attends: T(T+1)/2."""
    return T * (T + 1) // 2


def in_image_taps(size: int, k: int) -> int:
    """Taps of a stride-1 SAME conv, along one dimension, that land
    inside the image, summed over the output positions: the padding
    taps multiply zeros, so the bound does not count them."""
    pad = (k - 1) // 2
    return sum(min(o - pad + k, size) - max(o - pad, 0) for o in range(size))


PROCESS_SIZES = (1, 7, 64, 512, 4096)  # rows of the Process requests, in turn
F5_SERVERS = 5  # `up --grpc-port` servers SIGTERMed at once
PROCESS_THREADS = 10
# The digits record (artifacts/real_digits_r03/RECORD.json): its command,
# run on the card, and its held-out results; the bar is BASELINE's 0.97.
DIGITS_TRAIN = ["--data", "digits", "--layers", "64,128,64,10", "--epochs", "40",
                "--lr-schedule", "cosine", "--warmup-steps", "50"]
DIGITS_RECORD = dict(accuracy=0.9805013927576601, f1_score=0.9805454271308642, bar=0.97)
# Full-width training: the reference's 784-128-64-10 recipe (batch 64,
# Adam 1e-3) on 60,000 seeded synthetic_mnist rows, 10,000 held out.
TRAIN_ROWS, TRAIN_EVAL_ROWS, TRAIN_BATCH, TRAIN_EPOCHS = 60000, 10000, 64, 3
GRAPH_STEPS = 150  # steps a graphed-vs-eager arm times
GATE_MARGIN = 0.10  # kernel time ratios within 1 +- this: either gate decision stands


def timed_arms(arms: dict, order=("eager", "graphed", "graphed", "eager")):
    """Run ``arms[label]()`` (each returns ``(ms_per_step, tensors)``)
    in ``order``; fail unless every run's tensors equal the first run's
    bit for bit. Returns ``[(label, ms)]`` in run order."""
    import torch

    out, ref = [], None
    for label in order:
        ms, tensors = arms[label]()
        if ref is None:
            ref = tensors
        diff = sum(int((a != b).sum()) for a, b in zip(tensors, ref))
        if diff or len(tensors) != len(ref):
            fail(f"the {label} step's weights, Adam state or losses differ from the first "
                 f"arm's ({diff} elements)")
        out.append((label, ms))
    torch.cuda.synchronize()
    return out


def fcnn_step_arms(dev, train, n_steps):
    """The FCNN step eager and graphed (see ``timed_arms``): ``n_steps``
    batches of 64 after the first step, seeded init, host clock around
    the steps and a synchronise."""
    import torch

    from tpu_dist_nn_torch.models.fcnn import init_fcnn
    from tpu_dist_nn_torch.train.trainer import (
        TrainConfig,
        _leaves,
        _split_params,
        compile_train_step,
        make_train_step,
        optimizer_for,
    )

    bs = TRAIN_BATCH
    batches = [(train.x[i * bs:(i + 1) * bs], train.y[i * bs:(i + 1) * bs])
               for i in range(n_steps + 1)]

    def arm(graphed):
        wb, ids = _split_params(init_fcnn(torch.Generator().manual_seed(0), MNIST, ACTS,
                                          device=dev))
        opt = optimizer_for(TrainConfig(batch_size=bs), train)
        st = opt.init(_leaves(wb))
        step = make_train_step(ids, opt)
        if graphed:
            compiled = compile_train_step(step, wb, st, opt, bs, MNIST[0])
            run = compiled
        else:
            def run(bx, by):
                return step(wb, st, torch.as_tensor(bx, dtype=torch.float32, device=dev),
                            torch.as_tensor(by, dtype=torch.long, device=dev))[2]
        losses = [run(*batches[0]).clone()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for bx, by in batches[1:]:
            losses.append(run(bx, by).clone())
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / n_steps
        return ms, _leaves(wb) + st.mu + st.nu + [st.count] + losses

    return timed_arms({"eager": lambda: arm(False), "graphed": lambda: arm(True)})


RESUME_TOL = (1e-7, 1e-6)  # atol, rtol: tests/test_checkpoint.py:93's
CARD_CPU_LOSS_RTOL = 1e-4  # per-epoch losses, card vs CPU, TF32 off
PROCESS_STAGES = ("decode", "queue_wait", "stage", "launch", "fetch", "encode")


def process_requests(n_rows: int, sizes=PROCESS_SIZES) -> list[tuple[int, int]]:
    """(start, stop) row ranges cutting ``n_rows`` into requests of the
    sizes in turn."""
    out, a, i = [], 0, 0
    while a < n_rows:
        b = min(n_rows, a + sizes[i % len(sizes)])
        out.append((a, b))
        a, i = b, i + 1
    return out


def drive_handler(handler, payloads, threads=PROCESS_THREADS):
    """Send every payload through the Process handler body from
    ``threads`` threads, each taking the next request in turn. Returns
    the replies (bytes, or the RpcAbort raised) and each request's wall
    seconds, in payload order."""
    import threading

    from tpu_dist_nn_torch.serving.server import RpcAbort

    replies = [None] * len(payloads)
    walls = [0.0] * len(payloads)
    nxt = iter(range(len(payloads)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                replies[i] = handler(payloads[i])[0]
            except RpcAbort as e:
                replies[i] = e
            walls[i] = time.perf_counter() - t0

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    return replies, walls


def stage_medians(spans) -> dict[str, tuple[float, int]]:
    """Median milliseconds and count of each Process stage's spans."""
    import numpy as np

    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp.dur * 1e3)
    return {name: (float(np.median(by[name])), len(by[name]))
            for name in ("rpc.Process", *PROCESS_STAGES) if name in by}


def fetched_batches(spans) -> list[int]:
    """Bucket rows of each launched batch: every member request of a
    batch records one ``fetch`` span with the batch's start time."""
    seen = {}
    for sp in spans:
        if sp.name == "fetch":
            seen[sp.t0] = sp.attrs["batch_rows"]
    return list(seen.values())


def socket_phase(grpc, eng, model_path, data, reqs, tmp) -> None:
    """The Process path over loopback gRPC: serve_engine and GrpcClient
    on the first requests, the CLI's ``up --grpc-port`` with ``infer
    --target`` against the local ``infer``, and the ``--serving`` bench."""
    import signal
    import threading

    import numpy as np

    from tpu_dist_nn_torch.cli import main as cli_main
    from tpu_dist_nn_torch.core.schema import save_examples
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_engine

    print(f"grpc: {grpc.__version__}")
    server, port = serve_engine(eng, 0, host="127.0.0.1")
    sub = reqs[:10]
    outs = [None] * len(sub)

    def worker(k):
        client = GrpcClient(f"127.0.0.1:{port}")
        try:
            for i in range(k, len(sub), 5):
                a, b = sub[i]
                outs[i] = client.process(data[a:b])
        finally:
            client.close()

    pool = [threading.Thread(target=worker, args=(k,)) for k in range(5)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    client = GrpcClient(f"127.0.0.1:{port}", retry=None)
    try:
        client.process(np.zeros((5, MNIST[0] - 1)))
        code, message = None, None
    except grpc.RpcError as e:
        code, message = e.code(), e.details()
    finally:
        client.close()
    batches = server.batcher.batches_total
    server.stop(0)
    diff = sum(int((o != eng.infer(data[a:b]).astype(np.float64)).sum())
               for (a, b), o in zip(sub, outs))
    want_msg = f"expected input of shape (N, {MNIST[0]}), got (5, {MNIST[0] - 1})"
    ok = diff == 0 and code == grpc.StatusCode.INVALID_ARGUMENT and message == want_msg
    print(f"check Process over loopback gRPC: {len(sub)} requests from 5 clients in {batches} "
          f"batches, not-bit-equal to Engine.infer alone {diff}; wrong width {code} "
          f"{message!r} | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Process over the socket disagrees with the engine or its status")

    # The CLI: up --grpc-port in a subprocess, infer --target against it.
    examples = tmp / "examples_256.json"
    labels = eng.infer(data[:256]).argmax(-1)
    save_examples(data[:256], labels, examples)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cli = [sys.executable, "-m", "tpu_dist_nn_torch.cli"]
    up = subprocess.Popen(cli + ["up", "--config", str(model_path), "--grpc-port", "0",
                                 "--serve-seconds", "300", "--drain-grace-seconds", "2"],
                          cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    try:
        lines = []
        for line in up.stdout:
            lines.append(line.strip())
            if '"grpc_port"' in line:
                break
        if not lines or '"grpc_port"' not in lines[-1]:
            fail(f"cli up printed no grpc_port: {lines} {up.stderr.read()[-2000:]}")
        target = f"127.0.0.1:{json.loads(lines[-1])['grpc_port']}"
        remote = subprocess.run(cli + ["infer", "--target", target, "--inputs", str(examples),
                                       "--batch-size", "64"],
                                cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    finally:
        up.send_signal(signal.SIGTERM)
        up_rc = up.wait(timeout=120)
        up_err = up.stderr.read()
    local = io.StringIO()
    with contextlib.redirect_stdout(local):
        local_rc = cli_main(["infer", "--config", str(model_path), "--inputs", str(examples),
                             "--batch-size", "64"])
    for label, rc, text in (("cli up", up_rc, "\n".join(lines)),
                            ("cli infer --target", remote.returncode, remote.stdout),
                            ("cli infer (this process)", local_rc, local.getvalue())):
        print(f"{label} (rc {rc}):")
        for line in text.strip().splitlines():
            print(f"  {line}")

    def accuracy(out):
        return [ln for ln in out.splitlines() if ln.startswith("Correct predictions")]

    ok = (up_rc == 0 and remote.returncode == 0 and local_rc == 0
          and accuracy(remote.stdout) and accuracy(remote.stdout) == accuracy(local.getvalue())
          and '"ready": true' in lines[0])
    print(f"check cli infer --target accuracy line equals the local infer's | "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"cli up / infer --target: {remote.stderr[-1500:]}\ncli up's stderr: "
             f"{up_err[-3000:]}")

    # F5: `up --grpc-port` torn down by SIGTERM after serving, five more
    # servers at once (the fifth int8, its warm-up gate on), each
    # answering one request first: every exit code 0.
    servers = []
    for i in range(F5_SERVERS):
        extra = ["--quantize", "int8"] if i == F5_SERVERS - 1 else []
        env_i = {k: v for k, v in env.items() if k != "TDN_INT8_AUTO"} if extra else env
        servers.append(subprocess.Popen(
            cli + ["up", "--config", str(model_path), "--grpc-port", "0", "--serve-seconds",
                   "300", "--drain-grace-seconds", "2", *extra],
            cwd=ROOT, env=env_i, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    rcs, errs, served = [], [], []
    for proc in servers:
        try:
            port = None
            for line in proc.stdout:
                if '"grpc_port"' in line:
                    port = json.loads(line)["grpc_port"]
                    break
            if port is not None:
                client = GrpcClient(f"127.0.0.1:{port}")
                try:
                    served.append(client.process(data[:3]).shape == (3, MNIST[-1]))
                finally:
                    client.close()
        finally:
            proc.send_signal(signal.SIGTERM)
    for proc in servers:
        rcs.append(proc.wait(timeout=120))
        errs.append(proc.stderr.read())
    gate = [ln[ln.index("int8."):][:300] for ln in errs[-1].splitlines() if "int8." in ln]
    ok = rcs == [0] * F5_SERVERS and served == [True] * F5_SERVERS
    print(f"check F5: {F5_SERVERS} `up --grpc-port` servers at once, each SIGTERMed after "
          f"answering a request: return codes {rcs} | {'ok' if ok else 'FAIL'}")
    print(f"F5 int8 server's warm-up gate (TDN_INT8_AUTO unset, 64-row warm ladder): {gate}")
    if not ok:
        for rc, err in zip(rcs, errs):
            if rc != 0:
                print(f"server stderr (rc {rc}):\n{err[-3000:]}")
        fail(f"`up --grpc-port` exited {rcs} on SIGTERM (served {served})")

    bench = subprocess.run([sys.executable, "-m", "tpu_dist_nn_torch.bench", "--serving"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    print(f"bench --serving (rc {bench.returncode}): {bench.stdout.strip()}")
    if bench.returncode != 0:
        fail(f"bench --serving exited {bench.returncode}: {bench.stderr[-2000:]}")


def process_phase(dev, model, conv_model, data, rng, params, q, out_dir, smi_line, compare,
                  failures) -> None:
    """The reference's Process RPC in front of the port's engines on the
    card: in process through the handler body and the batcher (no
    grpcio), then over the socket where grpcio is installed."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import save_model
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        forward_quantized,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.obs.trace import TRACER
    from tpu_dist_nn_torch.serving.server import Batcher, RpcAbort, make_process_handler
    from tpu_dist_nn_torch.serving.wire import decode_matrix, encode_matrix
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.utils.profiling import cuda_graph_time_ms

    print(f"Process path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    spans = {}

    def serve(engine, spans_key, reqs, rows, depth=2, extra=None):
        """Requests of ``rows`` through a fresh batcher of ``depth``
        in front of ``engine``, counts zeroed just before and read just
        after; returns the decoded replies, walls, launches and the
        batcher."""
        payloads = [encode_matrix(rows[a:b]) for a, b in reqs]
        at = len(payloads) // 2
        if extra is not None:
            payloads.insert(at, extra)
        batcher = Batcher(engine, pipeline_depth=depth)
        handler = make_process_handler(engine, batcher)
        TRACER.reset()
        reset_launch_counts()
        replies, walls = drive_handler(handler, payloads)
        launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        batcher.close()
        spans[spans_key] = TRACER.snapshot()
        bad = None
        if extra is not None:
            bad = replies.pop(at)
            walls.pop(at)
        aborted = [r for r in replies if isinstance(r, RpcAbort)]
        if aborted:
            fail(f"Process {spans_key}: {len(aborted)} requests aborted, first "
                 f"{aborted[0].code}: {aborted[0].message}")
        outs = [decode_matrix(r) for r in replies]
        return outs, walls, launches, batcher, bad

    def launch_check(label, launches, kernels, batcher, n_req):
        want = {k: n * batcher.batches_total for k, n in kernels.items()}
        got = {k: launches[k] for k in kernels}
        ok = got == want and 0 < batcher.batches_total < n_req
        print(f"check Process {label}: {n_req} requests in {batcher.batches_total} batches; "
              f"launches {json.dumps(got)}, expected {json.dumps(want)} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"Process {label}: launches do not match the batches, or nothing coalesced")

    def alone_check(label, engine, reqs, rows, outs):
        """Each request's reply against Engine.infer on its rows alone."""
        diff = sum(int((o != engine.infer(rows[a:b]).astype(np.float64)).sum())
                   for (a, b), o in zip(reqs, outs))
        print(f"check Process {label} vs Engine.infer on each request's rows alone: "
              f"not-bit-equal {diff} | {'ok' if diff == 0 else 'FAIL'}")
        if diff:
            fail(f"Process {label}: a coalesced reply differs from its request alone")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        model_path = Path(tmp) / "mnist_fcnn.json"
        save_model(model, model_path)
        conv_path = Path(tmp) / "cifar_conv_mlp.json"
        save_model(conv_model, conv_path)

        # 1. In process: the handler body and the batcher, no socket.
        reqs = process_requests(len(data))
        eng = Engine.up(model_path, device=dev)
        t0 = time.perf_counter()
        outs, walls, launches, b32, _ = serve(eng, "f32", reqs, data)
        f32_wall = time.perf_counter() - t0
        print(f"Process f32 in process: {len(reqs)} requests ({len(data)} rows, sizes "
              f"{PROCESS_SIZES} in turn) from {PROCESS_THREADS} threads, depth 2: "
              f"{f32_wall:.4f} s wall, {len(data) / f32_wall:.1f} rows/s")
        launch_check("f32 depth 2", launches, {"fcnn_fused_forward": 1}, b32, len(reqs))
        got = np.concatenate(outs)
        o_err = float(np.abs(got - oracle_forward_batch(model, data)).max())
        print(f"check Process f32 replies vs float64 oracle ({len(data)} rows): max_abs "
              f"{o_err:.3e} | tol atol 1e-05 | {'ok' if o_err <= 1e-5 else 'FAIL'}")
        if o_err > 1e-5:
            fail("Process f32 replies disagree with the float64 oracle")
        alone_check("f32", eng, reqs, data, outs)

        # Serial (depth 1), with one wrong-width request among the others.
        bad_payload = encode_matrix(np.zeros((5, MNIST[0] - 1), np.float32))
        outs1, _, launches1, b1, bad = serve(eng, "f32 depth 1", reqs, data, depth=1,
                                             extra=bad_payload)
        launch_check("f32 depth 1", launches1, {"fcnn_fused_forward": 1}, b1, len(reqs))
        same = all(np.array_equal(a, b) for a, b in zip(outs, outs1))
        print(f"check Process depth 1 replies bit-equal to depth 2: {'ok' if same else 'FAIL'}")
        want_msg = f"expected input of shape (N, {MNIST[0]}), got (5, {MNIST[0] - 1})"
        ok = isinstance(bad, RpcAbort) and bad.code == "INVALID_ARGUMENT" and bad.message == want_msg
        print(f"check Process wrong width among {len(reqs)} served requests: "
              f"{getattr(bad, 'code', bad)} {getattr(bad, 'message', '')!r} | "
              f"{'ok' if ok else 'FAIL'}")
        if not (same and ok):
            fail("Process depth 1 differs from depth 2, or the wrong width was not refused alone")

        # int8: bit-equal to the int8 kernel on each request alone and
        # to the plain int8 chain on each request's rows (atol 0, rtol 0).
        engq = Engine.up(model_path, quantize="int8", device=dev)
        outsq, _, launchesq, bq, _ = serve(engq, "int8", reqs, data)
        launch_check("int8", launchesq, {"fcnn_quantized_forward": 1}, bq, len(reqs))
        alone_check("int8", engq, reqs, data, outsq)
        data_dev = torch.from_numpy(data).to(dev)
        plain = torch.cat([forward_quantized(q, data_dev[a:b]) for a, b in reqs]).cpu()
        compare("Process int8 replies vs plain forward_quantized on each request's rows",
                torch.from_numpy(np.concatenate(outsq)).float(), plain, 0.0, 0.0)
        del data_dev

        # The conv engine behind the handler: 1024 CIFAR rows.
        data_c = rng.uniform(0.0, 1.0, (CIFAR_BATCH, conv_model.input_dim)).astype(np.float32)
        reqs_c = process_requests(len(data_c), PROCESS_SIZES[:4])
        engc = Engine.up(conv_path, device=dev)
        outsc, _, launchesc, bc, _ = serve(engc, "conv", reqs_c, data_c)
        launch_check("conv", launchesc, {"fused_conv2d": 2, "fcnn_fused_forward": 1}, bc,
                     len(reqs_c))
        plain_c = Engine.up(conv_path, device="cpu").infer(data_c)
        compare("Process conv replies vs the plain versions (CPU engine)",
                torch.from_numpy(np.concatenate(outsc)).float(), torch.from_numpy(plain_c),
                *CONV_TOL)
        if failures:
            fail(f"Process checks failed: {failures}")

        # 2. Over the socket, where grpcio is installed.
        try:
            import grpc
        except ImportError:
            grpc = None
            print("grpc: not installed; socket phase not run")
        if grpc is not None:
            socket_phase(grpc, eng, model_path, data, reqs, Path(tmp))

    # 3. Numbers.
    for key, label in (("f32", "f32, depth 2"), ("f32 depth 1", "f32, depth 1"),
                       ("int8", "int8, depth 2"), ("conv", "conv, depth 2")):
        med = stage_medians(spans[key])
        print(f"Process stage medians ({label}): " + ", ".join(
            f"{name} {ms:.4f} ms (n={n})" for name, (ms, n) in med.items()))
    by_size = {}
    for (a, b), w in zip(reqs, walls):
        by_size.setdefault(b - a, []).append(w * 1e3)
    print("Process f32 request wall time by size (depth 2, 10 threads): " + ", ".join(
        f"{n} rows median {np.median(v):.3f} ms (n={len(v)})" for n, v in sorted(by_size.items())))
    buckets = fetched_batches(spans["f32"])
    xb = torch.from_numpy(np.resize(data, (max(buckets), data.shape[1]))).to(dev)
    kernel_ms = {n: cuda_graph_time_ms(lambda n=n: fcnn_fused_forward(params, xb[:n]), iters=20)
                 for n in sorted(set(buckets))}
    total = sum(kernel_ms[n] for n in buckets)
    print(f"Process f32 kernel device time for the same {len(buckets)} batches (buckets "
          f"{json.dumps(dict(sorted((n, buckets.count(n)) for n in set(buckets))))}): "
          f"{total:.4f} ms (CUDA graph a bucket: "
          f"{', '.join(f'{n} rows {ms:.4f} ms' for n, ms in kernel_ms.items())}) of "
          f"{f32_wall * 1e3:.1f} ms wall")
    del xb
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    bench = subprocess.run([sys.executable, "-m", "tpu_dist_nn_torch.bench"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
    print(f"bench (rc {bench.returncode}): {bench.stdout.strip()}")
    if bench.returncode != 0:
        fail(f"bench exited {bench.returncode}: {bench.stderr[-2000:]}")
    line = json.loads(bench.stdout.strip().splitlines()[-1])
    if line["backend"] != "cuda" or line["agreement"]["max_abs"] > 1e-5:
        fail(f"bench line: backend {line['backend']}, agreement {line['agreement']}")
    print(f"Process phase took {time.monotonic() - t_phase:.1f} s")


def train_phase(dev, model, data, out_dir, smi_line, compare, failures) -> None:
    """Native FCNN training on the card: the digits record's command
    through the CLI, full-width training through Engine.train with a
    checkpoint resume, card-vs-CPU losses, a trained int8 engine, and
    the int8 warm-up gate."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.checkpoint import CheckpointManager
    from tpu_dist_nn_torch.core.schema import load_model
    from tpu_dist_nn_torch.data.datasets import Dataset, real_digits, synthetic_mnist
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        fcnn_quantized_forward,
        forward_quantized,
        quantize_fcnn,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params
    from tpu_dist_nn_torch.train.trainer import TrainConfig, train_fcnn
    from tpu_dist_nn_torch.utils.profiling import device_call_ms

    print(f"train path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        tmp = Path(tmp)
        # (a) The digits record's command on the card, then the CLI's
        # infer of the exported model on the held-out digits.
        exported = tmp / "digits_model.json"
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "train", *DIGITS_TRAIN,
             "--out", str(exported)],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            fail(f"cli train exited {proc.returncode}: {proc.stderr[-2000:]}")
        epochs = [ln.split(" - INFO - ")[-1] for ln in proc.stderr.splitlines() if "epoch " in ln]
        print(f"cli train {' '.join(DIGITS_TRAIN)}: {wall:.1f} s wall (process start, "
              f"kernel build and 40 epochs); first and last epochs: {epochs[0]} | {epochs[-1]}")
        got = load_model(exported).metadata["inference_metrics"]
        ok = (got["accuracy"] >= DIGITS_RECORD["bar"] and got["f1_score"] >= DIGITS_RECORD["bar"])
        print(f"check digits recipe on the card, held-out: accuracy {got['accuracy']:.4f} F1 "
              f"{got['f1_score']:.4f} (record {DIGITS_RECORD['accuracy']:.4f} / "
              f"{DIGITS_RECORD['f1_score']:.4f}; bar {DIGITS_RECORD['bar']}) | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the digits recipe missed 0.97 held-out accuracy or F1 on the card")
        held = tmp / "digits_heldout.json"
        real_digits("test").to_examples_json(held)
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config",
             str(exported), "--inputs", str(held)],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("Metrics: ")]
        if proc.returncode != 0 or not lines:
            fail(f"cli infer of the trained model exited {proc.returncode}: {proc.stderr[-2000:]}")
        served = json.loads(lines[0][len("Metrics: "):])
        ok = served["accuracy"] == got["accuracy"]
        print(f"check cli infer of the exported model on the 359 held-out digits: accuracy "
              f"{served['accuracy']!r} vs the trainer's eval {got['accuracy']!r} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the served trained model's accuracy differs from the trainer's eval")

        # (b) Full width: Engine.up + Engine.train, eval each epoch.
        full = synthetic_mnist(TRAIN_ROWS + TRAIN_EVAL_ROWS, seed=0)
        train = Dataset(full.x[:TRAIN_ROWS], full.y[:TRAIN_ROWS], 10)
        held_out = Dataset(full.x[TRAIN_ROWS:], full.y[TRAIN_ROWS:], 10)
        spec = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), MNIST, ACTS,
                                          device="cpu"), ACTS)
        cfg = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=0)
        eng = Engine.up(spec, device=dev)
        reset_launch_counts()
        t0 = time.monotonic()
        hist = eng.train(train, cfg, eval_data=held_out)
        wall = time.monotonic() - t0
        launches = counts()
        steps = TRAIN_ROWS // TRAIN_BATCH
        for h in hist:
            print(f"train 784-128-64-10 epoch {h['epoch']}: loss {h['loss']:.6f}, "
                  f"{h['seconds']:.3f} s ({steps} steps of {TRAIN_BATCH} rows: "
                  f"{h['seconds'] / steps:.6f} s/step, "
                  f"{steps * TRAIN_BATCH / h['seconds']:.1f} samples/s), held-out accuracy "
                  f"{h['eval']['accuracy']:.4f}")
        print(f"train 784-128-64-10: {wall:.3f} s wall for {TRAIN_EPOCHS} epochs with eval; "
              f"launches {json.dumps(launches)}")
        losses = [h["loss"] for h in hist]
        if len(hist) != TRAIN_EPOCHS or not all(math.isfinite(x) for x in losses) or \
                not all(b < a for a, b in zip(losses, losses[1:])):
            fail(f"full-width training: the mean loss did not fall every epoch: {losses}")
        eval_batches = TRAIN_EPOCHS * math.ceil(TRAIN_EVAL_ROWS / 1024)
        want = {k: (eval_batches if k == "fcnn_fused_forward" else 0) for k in launches}
        ok = launches == want
        print(f"check training launches: none in the {TRAIN_EPOCHS * steps} steps, one chain "
              f"launch per eval batch ({eval_batches}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("training launched a kernel inside a step, or eval missed the chain kernel")

        # (b2) The compiled step beside the eager one: the same seeded
        # init and the same batches, in turns (eager, graphed, graphed,
        # eager); every arm's weights and Adam state after its steps,
        # and its losses, bit for bit equal (the same cuBLAS and
        # elementwise kernels run).
        step_ms = fcnn_step_arms(dev, train, GRAPH_STEPS)
        print(f"FCNN step 784-128-64-10 at batch {TRAIN_BATCH} on {smi_line}: " + "; ".join(
            f"{label} {ms:.4f} ms/step ({TRAIN_BATCH / ms * 1e3:.1f} samples/s)"
            for label, ms in step_ms))

        # 1 epoch, then a resume to 3: the straight run's weights.
        ckpt = CheckpointManager(tmp / "resume", keep=3)
        Engine.up(spec, device=dev).train(train, TrainConfig(epochs=1, batch_size=TRAIN_BATCH,
                                                             seed=0), checkpoints=ckpt)
        resumed = Engine.up(spec, device=dev)
        hist_r = resumed.train(train, cfg, checkpoints=ckpt)
        if len(hist_r) != TRAIN_EPOCHS - 1 or ckpt.latest_step() != TRAIN_EPOCHS:
            fail(f"resume re-ran {len(hist_r)} epochs to step {ckpt.latest_step()}")
        for i, (a, b) in enumerate(zip(resumed._params, eng._params)):
            for key in ("w", "b"):
                compare(f"resume 1 -> {TRAIN_EPOCHS} epochs vs straight, layer {i} {key}",
                        a[key], b[key], *RESUME_TOL)

        # (c) Two digits epochs on the card and on the CPU from one init.
        digits = real_digits("train")
        p0 = init_fcnn(torch.Generator().manual_seed(0), [64, 128, 64, 10], device="cpu")
        cfg_d = TrainConfig(epochs=2, batch_size=64, seed=0)
        _, h_card = train_fcnn([{**p, "w": p["w"].to(dev), "b": p["b"].to(dev)} for p in p0],
                               digits, cfg_d)
        _, h_cpu = train_fcnn(p0, digits, cfg_d)
        rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(h_card, h_cpu))
        ok = rel <= CARD_CPU_LOSS_RTOL
        print(f"check digits losses card vs CPU (2 epochs): {[h['loss'] for h in h_card]} vs "
              f"{[h['loss'] for h in h_cpu]}, max rel {rel:.3e} | tol rtol "
              f"{CARD_CPU_LOSS_RTOL:g} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("training on the card and on the CPU disagree")

        # (d) A trained int8 engine serves the re-quantized trained weights.
        test = real_digits("test")
        spec_d = spec_from_params(p0, ACTS)
        engq = Engine.up(spec_d, quantize="int8", device=dev)
        stale = engq._q
        engq.train(digits, cfg_d)
        reset_launch_counts()
        got_q = torch.from_numpy(engq.infer(test.x))
        int8_launches = fcnn_quantized_forward.launches
        x_test = torch.from_numpy(test.x).to(dev)
        compare("trained int8 engine vs plain forward_quantized of the re-quantized weights",
                got_q, forward_quantized(quantize_fcnn(engq._params), x_test).cpu(), 0.0, 0.0)
        moved = int((got_q != forward_quantized(stale, x_test).cpu()).sum())
        ok = int8_launches == 1 and moved > 0
        print(f"check trained int8 engine: int8 launches {int8_launches}, outputs that moved "
              f"from the untrained int8 weights {moved} | {'ok' if ok else 'FAIL'}")
        if failures or not ok:
            fail(f"train checks failed: {failures or 'the trained int8 engine'}")

        # (e) The int8 warm-up gate with TDN_INT8_AUTO unset (its
        # default, on), at the row count of `up --grpc-port`'s engine
        # (its 64-row warm ladder) and at 8,192 rows: its ratio and
        # decision beside the chain kernels' own event times at that row
        # count, then launches that follow the decision.
        for warm_rows in (64, BATCH):
            os.environ.pop("TDN_INT8_AUTO", None)
            try:
                engg = Engine.up(model, quantize="int8", warm_rows=warm_rows, device=dev)
            finally:
                os.environ["TDN_INT8_AUTO"] = "0"
            kept = not engg.int8_auto_disabled
            xg = torch.from_numpy(data[:warm_rows]).to(dev)
            f32_ms = device_call_ms(lambda: fcnn_fused_forward(engg._params, xg), calls=21)
            int8_ms = device_call_ms(lambda: fcnn_quantized_forward(engg._q, xg), calls=21)
            kernel_ratio = f32_ms / int8_ms
            contradicts = ((kernel_ratio > 1 + GATE_MARGIN and not kept)
                           or (kernel_ratio < 1 - GATE_MARGIN and kept))
            reset_launch_counts()
            engg.run_inference(data[:2 * warm_rows], batch_size=warm_rows)
            launches = counts()
            want = {"fcnn_quantized_forward": 2 if kept else 0,
                    "fcnn_fused_forward": 0 if kept else 2}
            ok = not contradicts and all(launches[k] == n for k, n in want.items())
            print(f"check int8 warm-up gate (TDN_INT8_AUTO unset) at {warm_rows} rows on "
                  f"{smi_line}: ratio f32/int8 {engg.int8_speedup_ratio:.4f} (CUDA-event device "
                  f"time of each arm's forward, median of 7), int8 "
                  f"{'kept' if kept else 'disabled'}; the chain kernels at {warm_rows} rows: "
                  f"f32 {f32_ms:.4f} ms, int8 {int8_ms:.4f} ms (device_call_ms: CUDA-event "
                  f"median of 21, the card busy while the host issues each), ratio "
                  f"{kernel_ratio:.4f}; a decision contradicts them past +-{GATE_MARGIN:g}; "
                  f"launches over 2 batches {json.dumps({k: launches[k] for k in want})} | "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail("the int8 warm-up gate's decision contradicts the kernels' device times, "
                     "or the launches do not follow it")
    print(f"train phase took {time.monotonic() - t_phase:.1f} s")


def pipeline_step_arms(dev, spec, train, schedule, dist, virtual, n_steps):
    """The pipelined step eager and graphed (see ``timed_arms``) on
    ``dist`` over ``len(dist) // virtual`` slots of ``dev``."""
    import torch

    from tpu_dist_nn_torch.core.schema import partition_model
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.pipeline import build_pipeline_params
    from tpu_dist_nn_torch.train.pipeline_trainer import (
        _leaves,
        compile_pipeline_step,
        make_pipeline_train_step,
        place_leaves,
        prepare_pipeline_batch,
    )
    from tpu_dist_nn_torch.train.trainer import TrainConfig, optimizer_for

    M, bs = PIPE_MICROBATCHES, TRAIN_BATCH
    pp = build_pipeline_params(partition_model(spec, dist))
    batches = [prepare_pipeline_batch(pp.meta, train.x[i * bs:(i + 1) * bs],
                                      train.y[i * bs:(i + 1) * bs], M, 1)
               for i in range(n_steps + 1)]

    def arm(graphed):
        stages = len(dist) // virtual
        mesh = build_mesh(MeshSpec(stage=stages), [dev] * stages)
        placed = place_leaves(mesh, pp, virtual)
        opt = optimizer_for(TrainConfig(batch_size=bs), train)
        st = opt.init(_leaves(placed))
        step = make_pipeline_train_step(mesh, pp.meta, M, opt, schedule=schedule,
                                        num_virtual=virtual)
        if graphed:
            compiled = compile_pipeline_step(step, placed, st, opt, M, bs)

            def run(xs, labels, mask):
                return compiled(xs[:, :, :pp.meta.in_dim], labels, mask)
        else:
            def run(xs, labels, mask):
                return step(placed, st, xs, labels, mask)[2]
        losses = [run(*batches[0]).clone()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for b in batches[1:]:
            losses.append(run(*b).clone())
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / n_steps
        return ms, _leaves(placed) + st.mu + st.nu + [st.count] + losses

    return timed_arms({"eager": lambda: arm(False), "graphed": lambda: arm(True)})


def lm_k_arms(cfg, params, batches, train_cfg, k, n_eager, first_losses, label, smi_line):
    """The LM step beside its graph: ``n_eager`` eager steps (the steady
    s/step of all but the first two), then ``train_cfg`` again as
    ``steps_per_call=k`` supersteps (the captured step replayed k times
    a call, losses read once),
    its logged losses held to ``first_losses`` (the K=1 run's loss at
    each step) bit for bit: every kernel of the step, the flash backward
    included, gives the same bits on every run. Prints s/step and
    tokens/s of each."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.models.transformer import param_leaves, tree_map
    from tpu_dist_nn_torch.train.lm_trainer import make_lm_train_step, train_lm
    from tpu_dist_nn_torch.train.optimizers import build_optimizer

    tokens = train_cfg.batch_size * train_cfg.seq_len
    opt = build_optimizer(train_cfg.learning_rate, schedule=train_cfg.lr_schedule,
                          warmup_steps=train_cfg.warmup_steps, total_steps=train_cfg.steps)
    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    state = opt.init(param_leaves(p))
    step = make_lm_train_step(cfg, opt)
    stamps = []
    for b in batches[:n_eager]:
        step(p, state, torch.as_tensor(b, device=param_leaves(p)[0].device).long())
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
    eager = (stamps[-1] - stamps[1]) / (len(stamps) - 2)
    del p, state
    torch.cuda.empty_cache()
    cfg_k = dataclasses.replace(train_cfg, steps_per_call=k, log_every=k)
    _, hist = train_lm(params, cfg, batches, cfg_k)
    graphed_k = (hist[-1]["seconds"] - hist[1]["seconds"]) / (hist[-1]["step"] - hist[1]["step"])
    got = np.array([h["loss"] for h in hist])
    want = np.array([first_losses[h["step"] - 1] for h in hist])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    ok = bool(np.isfinite(got).all()) and bool(np.array_equal(got, want))
    print(f"{label} on {smi_line}: eager {eager:.6f} s/step ({tokens / eager:.1f} tokens/s, "
          f"steps 3-{n_eager}); graphed K={k} ({k} replays a call, losses read once) "
          f"{graphed_k:.6f} s/step ({tokens / graphed_k:.1f} tokens/s, steps "
          f"{hist[1]['step'] + 1}-{hist[-1]['step']})")
    print(f"check {label} K={k} losses vs K=1 at the same steps: max rel {rel:.3e} | "
          f"bit-equal | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: the K={k} superstep's losses disagree with one step a call")
    return eager, graphed_k


# Conv training (conv_train_phase): BASELINE configs[3]'s network at full
# width (init_conv_mlp's defaults, seeded) on tdn train's synthetic rows
# and defaults (12,000 rows split 0.9, 5 epochs, batch 64, Adam 1e-3),
# single-program through the CLI and through [2, 2, 2] on three slots
# of the card (cut from three chips), 4 microbatches.
CONV_TRAIN_ROWS, CONV_DIST, CONV_MICRO, CONV_EPOCHS = 12000, [2, 2, 2], 4, 5
CONV_STEPS = 100  # steps a graphed-vs-eager conv arm times
HETERO_LOSS_RTOL = 1e-4  # tests/test_hetero_pipeline.py:127-135
HETERO_STEPS = 16  # that test's run: 2 epochs of 8 steps
HETERO_RESUME_TOL = (1e-7, 1e-5)  # its resume
HETERO_ROWS, HETERO_BATCH = 10000, 1024


class GradGrab:
    """An optimizer stand-in whose update keeps the gradients and applies
    nothing: a step built with it yields its loss and gradients."""

    def update(self, grads, state, leaves, *, micro_step=None):
        self.grads = [g.detach().clone() for g in grads]


def make_conv_step(dev, spec, dist, opt, clip_norm=None):
    """``(params, step)`` from ``spec``'s weights with ``opt``: the single
    program's conv step (``dist`` None) or the heterogeneous pipeline's
    on ``dist`` over slots of ``dev``, ``CONV_MICRO`` microbatches. The
    hetero step clips across its stages itself (JAX's rule), so it takes
    ``clip_norm`` and a clip-free ``opt``; the single program's ``opt``
    clips."""
    from tpu_dist_nn_torch.models.network import build_network
    from tpu_dist_nn_torch.parallel.hetero_pipeline import HeteroPipeline
    from tpu_dist_nn_torch.train.hetero_trainer import make_hetero_train_step
    from tpu_dist_nn_torch.train.trainer import _trainable, make_network_train_step

    if dist is None:
        plan, params = build_network(spec, device=dev)
        return _trainable(params), make_network_train_step(plan, opt)
    hp = HeteroPipeline(spec, dist, devices=[dev] * len(dist))
    return (_trainable(hp.stage_params()),
            make_hetero_train_step(hp, opt, CONV_MICRO, clip_norm=clip_norm))


def conv_step_arms(dev, spec, train, dist, n_steps):
    """The conv step eager and graphed (see ``timed_arms``): the single
    program (``dist`` None) or the heterogeneous pipeline on ``dist``
    over slots of ``dev``, ``n_steps`` batches of 64 after the first."""
    import torch

    from tpu_dist_nn_torch.train.trainer import (
        TrainConfig,
        _leaves,
        compile_train_step,
        optimizer_for,
    )

    bs = TRAIN_BATCH
    batches = [(train.x[i * bs:(i + 1) * bs], train.y[i * bs:(i + 1) * bs])
               for i in range(n_steps + 1)]

    def arm(graphed):
        opt = optimizer_for(TrainConfig(batch_size=bs), train)
        p, step = make_conv_step(dev, spec, dist, opt)
        st = opt.init(_leaves(p))
        if graphed:
            run = compile_train_step(step, p, st, opt, bs, spec.input_dim)
        else:
            def run(bx, by):
                return step(p, st, torch.as_tensor(bx, device=dev),
                            torch.as_tensor(by, dtype=torch.long, device=dev))[2]
        losses = [run(*batches[0]).clone()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for bx, by in batches[1:]:
            losses.append(run(bx, by).clone())
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / n_steps
        return ms, _leaves(p) + st.mu + st.nu + [st.count] + losses

    return timed_arms({"eager": lambda: arm(False), "graphed": lambda: arm(True)})


def conv_trajectories(dev, spec, train, n_steps, clip_norm):
    """The single program's and the hetero pipeline's captured steps from
    one init over the same ``n_steps`` batches of 64: ``{label: (losses,
    leaves)}`` after the last step."""
    from tpu_dist_nn_torch.train.trainer import (
        TrainConfig,
        _leaves,
        compile_train_step,
        optimizer_for,
    )

    bs = TRAIN_BATCH
    out = {}
    for label, dist in (("single", None), ("hetero", CONV_DIST)):
        opt = optimizer_for(TrainConfig(batch_size=bs, clip_norm=None if dist else clip_norm),
                            train)
        p, step = make_conv_step(dev, spec, dist, opt, clip_norm)
        run = compile_train_step(step, p, opt.init(_leaves(p)), opt, bs, spec.input_dim)
        losses = [float(run(train.x[i * bs:(i + 1) * bs], train.y[i * bs:(i + 1) * bs]))
                  for i in range(n_steps)]
        out[label] = (losses, [t.detach().clone() for t in _leaves(p)])
    return out


def conv_gradients_along(dev, spec, train, n_steps):
    """The hetero pipeline's gradients against the single program's at
    each of the single program's first ``n_steps`` weights (both steps
    eager, the hetero leaves set to the single program's before each):
    ``[(loss_rel, worst share of GRAD_TOL)]`` a step."""
    import torch

    from tpu_dist_nn_torch.train.trainer import TrainConfig, _leaves, optimizer_for

    bs, (atol, rtol) = TRAIN_BATCH, GRAD_TOL
    opt = optimizer_for(TrainConfig(batch_size=bs), train)
    p_s, step = make_conv_step(dev, spec, None, opt)
    st = opt.init(_leaves(p_s))
    grab_s, grab_h = GradGrab(), GradGrab()
    grads_s = make_conv_step(dev, spec, None, grab_s)[1]
    p_h, grads_h = make_conv_step(dev, spec, CONV_DIST, grab_h)
    out = []
    for i in range(n_steps):
        x = torch.as_tensor(train.x[i * bs:(i + 1) * bs], device=dev)
        y = torch.as_tensor(train.y[i * bs:(i + 1) * bs], dtype=torch.long, device=dev)
        with torch.no_grad():
            for a, b in zip(_leaves(p_h), _leaves(p_s)):
                a.copy_(b)
        loss_s = float(grads_s(p_s, None, x, y)[2])
        loss_h = float(grads_h(p_h, None, x, y)[2])
        share = max(float(((a - b).abs() / (atol + rtol * b.abs())).max())
                    for a, b in zip(grab_h.grads, grab_s.grads))
        out.append((abs(loss_h - loss_s) / abs(loss_s), share))
        step(p_s, st, x, y)
    return out


def conv_train_phase(dev, out_dir, smi_line, compare, failures) -> None:
    """Conv training on the card: ``tdn train --config`` single-program,
    ``tdn infer`` of its export, the step graphed beside eager, then the
    heterogeneous pipeline on [2, 2, 2]: held to the single program by
    the first-step loss and gradients, per-step losses over 16 steps
    (unclipped and clipped) and gradients along the single program's
    first 16 steps; trained through ``Engine.train`` over the recipe
    (launches, falling loss) and resumed against that run; its step
    graphed beside eager, its forward of 10,000 rows beside the
    single-program engine with the kernels' launches, and its dispatch
    overlap."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.checkpoint import CheckpointManager
    from tpu_dist_nn_torch.core.schema import load_model, save_model
    from tpu_dist_nn_torch.data.datasets import synthetic_mnist
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        fused_conv2d,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.models.network import build_network, init_conv_mlp
    from tpu_dist_nn_torch.parallel.hetero_pipeline import HeteroPipeline, measure_dispatch_overlap
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.train.hetero_trainer import train_hetero
    from tpu_dist_nn_torch.train.trainer import TrainConfig

    print(f"conv train path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    spec = init_conv_mlp(torch.Generator().manual_seed(0))
    full = synthetic_mnist(CONV_TRAIN_ROWS, dim=spec.input_dim, num_classes=10, seed=0)
    train, held = full.split(0.9, seed=0)
    cfg = TrainConfig(epochs=CONV_EPOCHS, batch_size=TRAIN_BATCH, seed=0)
    steps = len(train) // TRAIN_BATCH

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS if fn.launches}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        tmp = Path(tmp)
        # (a) Single program through the CLI, at tdn train's defaults.
        conv_json, exported, metrics = tmp / "conv.json", tmp / "conv_trained.json", tmp / "m.jsonl"
        save_model(spec, conv_json)
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "train", "--config", str(conv_json),
             "--num-examples", str(CONV_TRAIN_ROWS), "--epochs", str(CONV_EPOCHS),
             "--out", str(exported),
             "--metrics-out", str(metrics)],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            fail(f"cli train --config conv.json exited {proc.returncode}: {proc.stderr[-2000:]}")
        hist_cli = [json.loads(ln) for ln in metrics.read_text().splitlines()[1:]]
        for h in hist_cli:
            print(f"cli train --config conv.json (configs[3], single program) epoch {h['epoch']}: "
                  f"loss {h['loss']:.6f}, {h['seconds']:.3f} s ({steps} steps of {TRAIN_BATCH}: "
                  f"{h['seconds'] / steps * 1e3:.4f} ms/step), held-out accuracy "
                  f"{h['eval']['accuracy']:.4f}")
        acc = load_model(exported).metadata["inference_metrics"]["accuracy"]
        print(f"cli train --config conv.json: {wall:.1f} s wall (process start, kernel build, "
              f"{CONV_EPOCHS} epochs with eval, export); held-out accuracy {acc:.4f}")
        losses = [h["loss"] for h in hist_cli]
        if len(hist_cli) != CONV_EPOCHS or not all(b < a for a, b in zip(losses, losses[1:])):
            fail(f"conv training through the CLI: the mean loss did not fall every epoch: {losses}")
        held_json = tmp / "conv_heldout.json"
        held.to_examples_json(held_json)
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config", str(exported),
             "--inputs", str(held_json), "--batch-size", "1024"],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("Metrics: ")]
        if proc.returncode != 0 or not lines:
            fail(f"cli infer of the trained conv model exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        served = json.loads(lines[0][len("Metrics: "):])["accuracy"]
        ok = served == acc
        print(f"check cli infer of the exported conv model on the {len(held)} held-out rows: "
              f"accuracy {served!r} vs the trainer's eval {acc!r} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the served trained conv model's accuracy differs from the trainer's eval")
        trained_single = build_network(load_model(exported), device=dev)[1]

        # (b) The single-program step graphed beside eager, bit for bit.
        step_ms = conv_step_arms(dev, spec, train, None, CONV_STEPS)
        print(f"conv step (configs[3], single program) at batch {TRAIN_BATCH} on {smi_line}: "
              + "; ".join(f"{label} {ms:.4f} ms/step ({TRAIN_BATCH / ms * 1e3:.1f} samples/s)"
                          for label, ms in step_ms))

        # (c) The first step's loss and gradients, hetero vs single. The
        # process runs with cuDNN's TF32 off (main); here the flags are
        # PyTorch's defaults (TF32 on, nondeterministic algorithms
        # allowed), so the two agree only if each step sets its own
        # (conv_flags) around every conv it runs.
        bx = torch.from_numpy(train.x[:TRAIN_BATCH]).to(dev)
        by = torch.from_numpy(train.y[:TRAIN_BATCH]).to(dev).long()
        grab_s, grab_h = GradGrab(), GradGrab()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=True):
            p_s, step_s = make_conv_step(dev, spec, None, grab_s)
            loss_s = step_s(p_s, None, bx, by)[2]
            p_h, step_h = make_conv_step(dev, spec, CONV_DIST, grab_h)
            loss_h = step_h(p_h, None, bx, by)[2]
        compare(f"hetero {CONV_DIST} first-step loss vs single program", loss_h, loss_s,
                0.0, LOSS_RTOL)
        for i, (a, b) in enumerate(zip(grab_h.grads, grab_s.grads)):
            compare(f"hetero {CONV_DIST} first-step gradient {i} vs single program", a, b,
                    *GRAD_TOL)

        # (d) The hetero engine trains the recipe: eval launches counted,
        # the loss falling every epoch; the straight run (f) resumes to.
        eng = Engine.up(spec, CONV_DIST, devices=[dev] * len(CONV_DIST),
                        num_microbatches=CONV_MICRO)
        print(f"hetero engine placement: {json.dumps(eng.placement())}")
        reset_launch_counts()
        t0 = time.monotonic()
        hist_h = eng.train(train, cfg, eval_data=held)
        wall = time.monotonic() - t0
        launches = counts()
        for h in hist_h:
            print(f"hetero {CONV_DIST} train epoch {h['epoch']}: loss {h['loss']:.6f}, "
                  f"{h['seconds']:.3f} s ({h['seconds'] / steps * 1e3:.4f} ms/step), held-out "
                  f"accuracy {h['eval']['accuracy']:.4f}")
        print(f"hetero {CONV_DIST} train: {wall:.3f} s wall for {CONV_EPOCHS} epochs with eval; "
              f"launches {json.dumps(launches)}")
        want = {"fused_conv2d": 2 * CONV_EPOCHS, "fcnn_fused_forward": CONV_EPOCHS}
        ok = launches == want
        print(f"check hetero training launches: none in the {CONV_EPOCHS * steps} steps; each "
              f"epoch's eval one chunk: 2 conv and 1 chain launches | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("hetero training launched a kernel inside a step, or its eval missed one")
        # The two 840-step runs are not held at JAX's tolerances: microbatch
        # means and cuDNN's algorithm at 16 rows round otherwise than one
        # 64-row program, and Adam carries those last bits into a trajectory
        # that drifts apart as the loss falls to 1e-4 (the first step's loss
        # is bit-equal, its gradients within GRAD_TOL). Held-out accuracy is
        # printed beside the single program's; on these synthetic rows both
        # read 1.0000 from epoch 0, so it cannot tell a wrong pipeline from
        # a right one: (c) and (e) hold what the pipeline computes.
        rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hist_h, hist_cli)]
        trained_h = build_network(eng.model, device=dev)[1]
        w_diff = max(float((a[k] - b[k]).abs().max())
                     for a, b in zip(trained_h, trained_single) for k in a)
        print(f"hetero {CONV_DIST} vs single program over {CONV_EPOCHS} epochs (the trajectories "
              f"drift apart, not a gate): per-epoch loss rel "
              f"{', '.join(f'{r:.3e}' for r in rels)}; final weights max_abs {w_diff:.3e}")
        acc_h, acc_s = hist_h[-1]["eval"]["accuracy"], hist_cli[-1]["eval"]["accuracy"]
        h_losses = [h["loss"] for h in hist_h]
        ok = all(b < a for a, b in zip(h_losses, h_losses[1:]))
        print(f"check hetero {CONV_DIST} training: loss falling every epoch | "
              f"{'ok' if ok else 'FAIL'}; held-out accuracy {acc_h:.4f} (single program "
              f"{acc_s:.4f}; saturated, not a gate)")
        if not ok:
            fail("the hetero pipeline's training loss did not fall every epoch")

        # (e) The JAX test's run length (16 steps), unclipped and with
        # clip_norm 0.05: per-step losses, hetero vs single program, at
        # JAX's rtol 1e-4. The weights after them are printed, not held:
        # Adam moves a weight by about lr whatever its gradient's size,
        # so a gradient at the rounding level whose sign differs between
        # the two programs moves that weight 2 lr apart (the first
        # conv's filters). What the pipeline computes is held instead at
        # each of the 16 steps: its gradients from the single program's
        # weights, within GRAD_TOL.
        for clip in (None, 0.05):
            traj = conv_trajectories(dev, spec, train, HETERO_STEPS, clip)
            (l_s, w_s), (l_h, w_h) = traj["single"], traj["hetero"]
            rels = [abs(a - b) / abs(b) for a, b in zip(l_h, l_s)]
            ok = max(rels) <= HETERO_LOSS_RTOL
            print(f"check hetero {CONV_DIST} vs single program, {HETERO_STEPS} steps, clip_norm "
                  f"{clip}: per-step loss rel at steps 1, 4, 8, 16: "
                  f"{', '.join(f'{rels[i - 1]:.3e}' for i in (1, 4, 8, 16))}, max "
                  f"{max(rels):.3e} | tol rtol {HETERO_LOSS_RTOL:g} | {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"hetero losses clip {clip}")
            print(f"hetero {CONV_DIST} vs single program, clip_norm {clip}, weights after "
                  f"{HETERO_STEPS} steps (not a gate): max_abs by leaf "
                  + ", ".join(f"{float((a - b).abs().max()):.3e}" for a, b in zip(w_h, w_s)))
        along = conv_gradients_along(dev, spec, train, HETERO_STEPS)
        worst = max(share for _, share in along)
        ok = worst <= 1.0 and max(rel for rel, _ in along) <= LOSS_RTOL
        print(f"check hetero {CONV_DIST} gradients from the single program's weights at each of "
              f"its first {HETERO_STEPS} steps: largest share of GRAD_TOL (atol {GRAD_TOL[0]:g} "
              f"rtol {GRAD_TOL[1]:g}) {worst:.3f}, loss max rel "
              f"{max(rel for rel, _ in along):.3e} (tol {LOSS_RTOL:g}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("hetero gradients along the single program's steps")
        if failures:
            fail(f"the hetero pipeline disagrees with the single program: {failures}")

        # (f) train_hetero cut after epoch 2 and resumed, vs straight.
        ck = CheckpointManager(tmp / "hetero_resume", keep=2)
        train_hetero(HeteroPipeline(spec, CONV_DIST, devices=[dev] * 3), train,
                     TrainConfig(epochs=2, batch_size=TRAIN_BATCH, seed=0), checkpoints=ck,
                     num_microbatches=CONV_MICRO)
        resumed, hist_r = train_hetero(HeteroPipeline(spec, CONV_DIST, devices=[dev] * 3), train,
                                       cfg, checkpoints=ck, num_microbatches=CONV_MICRO)
        if [h["epoch"] for h in hist_r] != list(range(2, CONV_EPOCHS)):
            fail(f"the hetero resume ran epochs {[h['epoch'] for h in hist_r]}")
        for i, (a, b) in enumerate(zip([q for sp in resumed for q in sp], trained_h)):
            for key in a:
                compare(f"hetero resume 2 -> {CONV_EPOCHS} epochs vs straight, layer {i} {key}",
                        a[key], b[key], *HETERO_RESUME_TOL)

        # (g) The hetero step graphed beside eager, bit for bit.
        step_ms = conv_step_arms(dev, spec, train, CONV_DIST, CONV_STEPS)
        print(f"hetero {CONV_DIST} step at batch {TRAIN_BATCH}, {CONV_MICRO} microbatches, on "
              f"{smi_line}: " + "; ".join(
                  f"{label} {ms:.4f} ms/step ({TRAIN_BATCH / ms * 1e3:.1f} samples/s)"
                  for label, ms in step_ms))

        # (h) The forward: 10,000 rows at batch 1024 through [2, 2, 2]
        # (len // 4 rows a chunk) beside the single-program engine.
        x = np.random.default_rng(3).uniform(0, 1, (HETERO_ROWS, spec.input_dim)).astype(
            np.float32)
        one = Engine.up(eng.model, device=dev)
        reset_launch_counts()
        res_h = eng.run_inference(x, batch_size=HETERO_BATCH)
        launches = counts()
        res_1 = one.run_inference(x, batch_size=HETERO_BATCH)
        n_b = math.ceil(HETERO_ROWS / HETERO_BATCH)
        want = {"fused_conv2d": 2 * CONV_MICRO * n_b, "fcnn_fused_forward": CONV_MICRO * n_b}
        ok = launches == want
        print(f"check hetero forward launches over {n_b} batches of {HETERO_BATCH}: "
              f"{json.dumps(launches)} (2 conv and 1 chain a microbatch) | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the hetero forward did not launch the conv and chain kernels per microbatch")
        p50 = sorted(res_h.batch_seconds)[len(res_h.batch_seconds) // 2]
        p50_1 = sorted(res_1.batch_seconds)[len(res_1.batch_seconds) // 2]
        print(f"hetero {CONV_DIST} forward of {HETERO_ROWS} rows at batch {HETERO_BATCH} on "
              f"{smi_line}: {HETERO_ROWS / res_h.seconds:.1f} samples/s, batch p50 "
              f"{p50 * 1e3:.3f} ms; single program {HETERO_ROWS / res_1.seconds:.1f} samples/s, "
              f"batch p50 {p50_1 * 1e3:.3f} ms")
        differ = int((res_h.outputs != res_1.outputs).sum())
        o_err = float(np.abs(res_h.outputs[:1024] - oracle_forward_batch(eng.model,
                                                                         x[:1024])).max())
        ok = differ == 0 or o_err <= 1e-5
        print(f"check hetero forward vs the single-program engine: not-bit-equal {differ} "
              f"(max_abs {float(np.abs(res_h.outputs - res_1.outputs).max()):.3e}); vs the "
              f"float64 oracle on 1024 rows max_abs {o_err:.3e} | bit-equal, or atol 1e-05 of "
              f"the oracle | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the hetero forward disagrees with the single program and the oracle")

        # (i) How far the host runs ahead of the microbatched forward.
        m = measure_dispatch_overlap(eng._hp, x[:8192], microbatch_size=1024)
        print(f"hetero dispatch overlap ({m['num_chunks']} chunks x {m['num_stages']} stages of "
              f"1024 rows, host clock, min of 3) on {smi_line}: {json.dumps(m)}")
        if failures:
            fail(f"conv train checks failed: {failures}")
    print(f"conv train phase took {time.monotonic() - t_phase:.1f} s")


# Generation: the 85M LM's decode at full width, batch 16, a
# 128-byte prompt and 512 new tokens (a 639-position cache).
GEN = dict(batch=16, prompt=128, new=512, runs=3, check_depth=2, check_tokens=64, gap=1e-3,
           temperature=0.8, top_k=40, top_p=0.9, seed=1234)
RESUME_BAND = 0.01  # nats: tdn lm interrupted + resumed against straight, held-out


class Interrupted(Exception):
    """Raised by the recipe's batch stream to cut a `tdn lm` run short."""


def generate_phase(dev, cfg, params, eval_rows, out_dir, smi_line, rates) -> None:
    """The generation path on the trained 85M params (``cfg``: its bf16
    config), then ``tdn lm``'s float32 recipe through ``--checkpoint-dir
    --sample-bytes``, and one asynchronous 85M save. Every check fails
    the run (module docstring, phase 3)."""
    import dataclasses as dc

    import numpy as np
    import torch

    import tpu_dist_nn_torch.data.text as text_mod
    from tpu_dist_nn_torch.checkpoint import AsyncCheckpointManager
    from tpu_dist_nn_torch.cli import main as cli_main
    from tpu_dist_nn_torch.models.generate import (
        _NEG,
        _compiled_generate,
        _truncate_logits,
        copy_cache_slot,
        decode_step,
        decode_step_slots,
        generate,
        init_slot_cache,
        prefill,
        prefill_chunk_into_cache,
        prefill_into_cache,
    )
    from tpu_dist_nn_torch.models.transformer import (
        dot_product_attention,
        forward,
        num_params,
        param_leaves,
        tree_map,
    )
    from tpu_dist_nn_torch.train.optimizers import build_optimizer

    t_phase = time.monotonic()
    mem_rate, bf16_rate = rates
    B, T, N = GEN["batch"], GEN["prompt"], GEN["new"]
    M = T + N - 1
    prompt = torch.as_tensor(np.asarray(eval_rows[:B, :T]), device=dev).long()

    def events_ms(*fns):
        """Each ``fn`` run in turn between CUDA events: their times (ms)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
        ev[0].record()
        for e, fn in zip(ev[1:], fns):
            fn()
            e.record()
        ev[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    # 1. Greedy, the decode step graphed and eager in turns (a warm-up of
    # each first: the graphed arm's is its capture).
    prog = _compiled_generate(cfg, B, T, N, 0.0, None, None, None, prompt.device)
    times = {"eager": [], "graphed": []}
    outs = []
    for arm in ("eager", "graphed") + ("eager", "graphed", "graphed", "eager"):
        start_ms, decode_ms = events_ms(lambda: prog.start(params, prompt, None),
                                        lambda arm=arm: prog.decode(graphed=arm == "graphed"))
        outs.append(prog.state.out.clone())
        times[arm].append((start_ms, decode_ms))
    greedy = outs[1]
    same = all(torch.equal(o, greedy) for o in outs)
    prefill_ms = [events_ms(lambda: prefill(prog.state.params, prompt, cfg, M))[0]
                  for _ in range(GEN["runs"])]
    print(f"generate 85M bf16 (B {B}, prompt {T}, {N} new, cache {M}) on {smi_line}: "
          f"{num_params(params):,} params; graph replays {prog.graph.replays}")
    summary = {}
    for arm in ("eager", "graphed"):
        runs = times[arm][1:]  # after its warm-up
        step_ms = float(np.median([d / (N - 1) for _, d in runs]))
        start_ms = float(np.median([s for s, _ in runs]))
        tok_s = float(np.median([B * N / ((s + d) / 1e3) for s, d in runs]))
        summary[arm] = step_ms
        print(f"  {arm}: decode {step_ms:.4f} ms/step (median of {len(runs)}: "
              f"{json.dumps([round(d / (N - 1), 4) for _, d in runs])}), {B / step_ms * 1e3:.1f} "
              f"tokens/s decoding, {tok_s:.1f} tokens/s end to end; start (params cast, "
              f"prefill, first sample) {start_ms:.3f} ms")
    print(f"  prefill alone (B {B} x {T}): {float(np.median(prefill_ms)):.3f} ms (median of "
          f"{GEN['runs']}: {json.dumps([round(t, 3) for t in prefill_ms])})")
    # The least time of one decode step: the bf16 weights it reads (all
    # but the positional table) and the K/V cache, over the memory rate;
    # the step reads the whole cache extent (JAX's form), its data needs
    # the keys up to its position (the mean over the run).
    w_bytes = 2.0 * (num_params(params) - params["pos_embed"].numel())
    kv_row = 2 * 2.0 * cfg.n_layers * B * cfg.n_heads * cfg.head_dim  # k and v, bf16
    live = T + (N - 2) / 2.0
    flops = 2.0 * B * (num_params(params) - params["pos_embed"].numel())
    flops += 4.0 * B * cfg.n_layers * cfg.n_heads * cfg.head_dim * live
    b_full = max((w_bytes + kv_row * M) / mem_rate, flops / bf16_rate) * 1e3
    b_live = max((w_bytes + kv_row * live) / mem_rate, flops / bf16_rate) * 1e3
    print(f"  bound a decode step: {b_live:.4f} ms (bytes: {w_bytes / 1e6:.1f} MB weights + "
          f"{kv_row * live / 1e6:.1f} MB of live K/V, mean position {live:.0f}); reading the "
          f"whole {M}-position cache as the step does: {b_full:.4f} ms "
          f"({kv_row * M / 1e6:.1f} MB K/V); graphed at {b_live / summary['graphed'] * 100:.1f}% "
          f"of the first, {summary['eager'] / summary['graphed']:.2f}x eager's speed")
    print(f"check graphed greedy tokens bit-equal to eager ({len(outs)} runs of {B} x {N}) | "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail("graphed greedy decode differs from the eager decode")
    prog = None
    _compiled_generate.cache_clear()
    torch.cuda.empty_cache()

    # 2. float32, depth 2 (the trained params' first two blocks), TF32
    # off: greedy tokens against the teacher-forced argmax.
    cfg2 = dc.replace(cfg, n_layers=GEN["check_depth"], compute_dtype="float32", remat=False)
    p2 = {**params, "blocks": {k: v[:GEN["check_depth"]] for k, v in params["blocks"].items()}}
    n_chk = GEN["check_tokens"]
    out2 = generate(p2, cfg2, prompt, n_chk)
    with torch.no_grad():
        tf = forward(p2, torch.cat([prompt, out2], 1), cfg2, dot_product_attention)[:, T - 1:-1]
    top2 = tf.topk(2, dim=-1).values
    miss = (tf.argmax(-1) != out2).nonzero().tolist()
    gaps = [float(top2[b, i, 0] - top2[b, i, 1]) for b, i in miss]
    first = (f"first at row {miss[0][0]} token {miss[0][1]}, top-2 gap {gaps[0]:.3e}"
             if miss else "none")
    ok2 = all(g <= GEN["gap"] for g in gaps)
    print(f"check float32 depth-2 greedy vs teacher-forced argmax ({B} x {n_chk} tokens): "
          f"{len(miss)} divergences ({first}; largest gap {max(gaps, default=0.0):.3e}) | tol a "
          f"divergence's top-2 gap <= {GEN['gap']:g} | {'ok' if ok2 else 'FAIL'}")
    if not ok2:
        fail("float32 greedy decode diverges from the teacher-forced argmax past a near-tie")
    del p2, out2, tf
    _compiled_generate.cache_clear()

    # 3. The bit-equal pairs at full width (bf16): the slot step at one
    # position against the scalar step; a prompt prefilled in chunks,
    # and after a copied prefix, against the monolithic slot prefill.
    with torch.no_grad():
        _, cache = prefill(params, prompt, cfg, M)
        ref = {k: v.clone() for k, v in cache.items()}
        tok = greedy[:, 0]
        ref_logits, ref = decode_step(params, ref, torch.tensor(T, device=dev), tok, cfg)
        got_logits, cache = decode_step_slots(params, cache, torch.full((B,), T, device=dev), tok,
                                              cfg)
        ok_slot = (torch.equal(ref_logits, got_logits) and torch.equal(ref["k"], cache["k"])
                   and torch.equal(ref["v"], cache["v"]))
        del cache, ref
        slots = init_slot_cache(cfg, 4, M, device=dev)
        one = prompt[:1]
        cut, pre_len = T * 5 // 16, T // 2  # 40 + 88, and a 64-token prefix
        mono_logits, mono = prefill_into_cache(
            params, cfg, {k: v.clone() for k, v in slots.items()}, 2, one)
        _, split = prefill_chunk_into_cache(params, cfg, {k: v.clone() for k, v in slots.items()},
                                            2, one[:, :cut], 0)
        split_logits, split = prefill_chunk_into_cache(params, cfg, split, 2, one[:, cut:],
                                                       torch.tensor(cut, device=dev))
        _, pre = prefill_chunk_into_cache(params, cfg, slots, 0, one[:, :pre_len], 0)
        pre = copy_cache_slot(pre, 0, 3)
        copy_logits, pre = prefill_chunk_into_cache(params, cfg, pre, 3, one[:, pre_len:],
                                                    pre_len)
        ok_chunk = (torch.equal(mono_logits, split_logits)
                    and all(torch.equal(mono[p], split[p]) for p in ("k", "v"))
                    and torch.equal(mono_logits, copy_logits)
                    and all(torch.equal(mono[p][:, 2, :T], pre[p][:, 3, :T]) for p in ("k", "v")))
    print(f"check decode_step_slots at one position bit-equal to decode_step (B {B}, cache {M}) "
          f"| {'ok' if ok_slot else 'FAIL'}")
    print(f"check prefill_chunk_into_cache {cut} + {T - cut} and after a copied {pre_len}-token "
          f"prefix bit-equal to prefill_into_cache ({T} tokens, 4 slots of {M}) | "
          f"{'ok' if ok_chunk else 'FAIL'}")
    if not (ok_slot and ok_chunk):
        fail("a slot-cache contract is not bit-equal on the card")
    del slots, mono, split, pre
    torch.cuda.empty_cache()

    # 4. Sampling at temperature 0.8, top-k 40, top-p 0.9.
    kw = dict(temperature=GEN["temperature"], top_k=GEN["top_k"], top_p=GEN["top_p"])
    gen = torch.Generator(device=dev).manual_seed(GEN["seed"])
    a = generate(params, cfg, prompt, N, generator=gen, **kw)
    b = generate(params, cfg, prompt, N, generator=gen, **kw)  # the generator moved on
    c = generate(params, cfg, prompt, N,
                 generator=torch.Generator(device=dev).manual_seed(GEN["seed"]), **kw)
    sampled_ms = events_ms(lambda: generate(params, cfg, prompt, N, generator=gen, **kw))[0]
    with torch.no_grad():  # each draw's own logits, stepped eagerly through the cache
        logits, cache = prefill(params, prompt, cfg, M)
        logits = logits[:, T - 1]
        outside = 0
        for i in range(N):
            allowed = _truncate_logits(logits, GEN["top_k"], GEN["top_p"]) > _NEG
            outside += int((~allowed.gather(1, a[:, i:i + 1])).sum())
            if i < N - 1:
                logits, cache = decode_step(params, cache, T + i, a[:, i], cfg)
    del cache
    ok_s = outside == 0 and torch.equal(a, c) and not torch.equal(a, b)
    print(f"sampled generate (T {GEN['temperature']}, top-k {GEN['top_k']}, top-p "
          f"{GEN['top_p']}, graphed): {sampled_ms:.3f} ms for {B} x {N} tokens "
          f"({B * N / sampled_ms * 1e3:.1f} tokens/s); first row: "
          f"{bytes(a[0, :48].tolist()).decode('utf-8', 'replace')!r}")
    print(f"check sampling: {outside} of {B * N} draws outside their truncated set; the same "
          f"seed repeats: {torch.equal(a, c)}; a second call of one generator differs: "
          f"{not torch.equal(a, b)} | {'ok' if ok_s else 'FAIL'}")
    if not ok_s:
        fail("sampling broke a property (truncated set, seed repeat, draws that move on)")
    _compiled_generate.cache_clear()
    torch.cuda.empty_cache()

    # 5. tdn lm's float32 recipe through --checkpoint-dir and
    # --sample-bytes 64: straight, and cut at step 200 (the stream raises
    # there; the asynchronous saves land on the way out) then resumed.
    recipe = ["lm", "--corpus", str(ROOT / RECIPE["corpus"]), "--steps", str(RECIPE["steps"]),
              "--warmup-steps", str(RECIPE["warmup"]), "--lr-schedule", "cosine", "--lr",
              str(RECIPE["lr"]), "--seed", str(RECIPE["seed"]), "--sample-bytes", "64"]
    cut = RECIPE["steps"] // 2
    real_batches = text_mod.lm_batches

    def cut_batches(*args, **kwargs):
        for i, batch in enumerate(real_batches(*args, **kwargs)):
            if i == cut:
                raise Interrupted(f"cut before step {cut + 1}")
            yield batch

    def run_cli(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(args)
        if rc != 0:
            fail(f"cli {' '.join(args)} exited {rc}")
        return json.loads(out.getvalue().strip().splitlines()[-1])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        straight = run_cli(recipe + ["--checkpoint-dir", f"{tmp}/straight"])
        text_mod.lm_batches = cut_batches
        try:
            run_cli(recipe + ["--checkpoint-dir", f"{tmp}/cut", "--async-checkpoints"])
            fail("the cut recipe run was not cut")
        except Interrupted:
            pass
        finally:
            text_mod.lm_batches = real_batches
        saved = json.loads(Path(f"{tmp}/cut/manifest.json").read_text())["latest_step"]
        resumed = run_cli(recipe + ["--checkpoint-dir", f"{tmp}/cut"])
        d = abs(straight["loss_nats_per_token"] - resumed["loss_nats_per_token"])
        ok_r = (saved == cut and math.isfinite(d) and d <= RESUME_BAND
                and "sample" in straight and "sample" in resumed)
        for label, rep in (("straight", straight), (f"cut at {saved}, resumed", resumed)):
            print(f"tdn lm recipe --checkpoint-dir --sample-bytes 64, {label}: held-out "
                  f"{rep['loss_nats_per_token']!r} nats, final train loss "
                  f"{rep['final_train_loss']!r}, {rep['train_seconds']} s; sample "
                  f"{rep['sample']!r}")
        print(f"check tdn lm resumed held-out within {RESUME_BAND} nats of straight: {d:.4f} "
              f"(saved step {saved}, want {cut}) | {'ok' if ok_r else 'FAIL'}")
        if not ok_r:
            fail("tdn lm interrupted and resumed does not land on the straight run")

        # 6. One asynchronous save of the 85M training state (float32
        # params and two Adam moments): how long the step waits on the
        # host snapshot, the write behind it, and a bit-exact restore.
        leaves = param_leaves(params)
        opt_state = build_optimizer(3e-4).init(leaves)
        torch._foreach_copy_(opt_state.mu, [p * 0.5 for p in leaves])
        torch._foreach_copy_(opt_state.nu, [p * p for p in leaves])
        state = {"params": params, "opt_state": opt_state}
        nbytes = 3 * 4 * num_params(params)
        mgr = AsyncCheckpointManager(f"{tmp}/ck85")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(LM["steps"], state)
        snap_s = time.perf_counter() - t0
        mgr.wait()
        write_s = time.perf_counter() - t0
        template = {"params": tree_map(torch.zeros_like, params),
                    "opt_state": build_optimizer(3e-4).init(leaves)}
        step, back = mgr.restore(template)
        mgr.close()
        ok_c = step == LM["steps"] and all(
            torch.equal(x, y) for x, y in zip(
                param_leaves(back["params"]) + back["opt_state"].mu + back["opt_state"].nu,
                leaves + opt_state.mu + opt_state.nu))
        print(f"async save of the 85M training state ({nbytes / 1e9:.3f} GB: params, mu, nu "
              f"in float32) on {smi_line}: the step waits {snap_s * 1e3:.1f} ms for the host "
              f"snapshot ({nbytes / snap_s / 1e9:.2f} GB/s), durable after "
              f"{write_s * 1e3:.1f} ms")
        print(f"check the 85M checkpoint restores bit-exact onto the card | "
              f"{'ok' if ok_c else 'FAIL'}")
        if not ok_c:
            fail("the 85M checkpoint does not restore bit-exact")
        del state, template, back, opt_state
    torch.cuda.empty_cache()
    print(f"generate phase took {time.monotonic() - t_phase:.1f} s")


SERVE = dict(slots=16, prompt=128, new=256, chunk=64, blocks=4, requests=24, threads=12,
             shared=64, critical=4, streams=4, seed=4321, step_runs=50, chunk_runs=10,
             logit_tol=0.25, min_budget=16, qk_scale=2.0,
             rpc_workers=32)  # the server's handler threads: a stream holds one to its end


def pick_eos(tails, budget, quick):
    """The eos id for the served load, from each request's continuation
    without eos (``tails`` (R, N)): the token that ends the most
    requests within their budgets but after their first ``quick``
    tokens, while as many others never emit it within theirs. Returns
    (eos, requests it ends late, requests it ends within ``quick``,
    requests it leaves to their budget)."""
    import numpy as np

    best = None
    for v in np.unique(tails):
        hit = tails == v
        first = np.where(hit.any(axis=1), hit.argmax(axis=1), tails.shape[1])
        ends = int(sum(int(k) < b for k, b in zip(first, budget)))
        early = int((first < quick).sum())
        key = (min(ends - early, len(budget) - ends), -early, -int(v))
        if best is None or key > best[0]:
            best = (key, int(v), ends - early, early, len(budget) - ends)
    return best[1:]


def serving_phase(dev, cfg, eval_rows, out_dir, smi_line) -> None:
    """LM serving on the 85M LM in bf16 (``cfg``), seeded init params
    with sharper attention (``SERVE["qk_scale"]``):
    ``serve_lm_generate`` with the continuous scheduler (16 slots,
    128-byte held-out prompts, 256 new tokens, 64-token prefill chunks,
    4 prefix blocks) on a loopback port. The eos id comes from a probe:
    every load prompt through a scheduler without eos or prefix cache
    (also (d)'s prefix-off arm), and ``pick_eos`` over its
    continuations. The load: 24 requests from 12 threads (half share a
    64-byte header), every other one a ``Generate`` RPC, the rest
    submitted to the scheduler with per-request budgets of 16 to 255
    tokens. Then 4 best_effort ``GenerateStream`` requests bind first,
    the 12 longest other load requests fill the other slots, and 4
    critical ``Generate`` requests are sent while the loop holds the
    full house with the streams decoding, so preemption evicts the
    streams (resumed by forced-token replay). Checks (a)-(g), each fatal (module
    docstring, phase 3); the load's requests alone on the scheduler are
    the reference of (a), (c), (e) and (g). Then the same 24 prompts
    through the static arm (printed only)."""
    import threading

    import numpy as np
    import torch

    from tpu_dist_nn_torch.models.generate import prefill_chunk_into_cache
    from tpu_dist_nn_torch.models.transformer import forward, init_transformer, num_params
    from tpu_dist_nn_torch.obs.registry import REGISTRY
    from tpu_dist_nn_torch.serving.continuous import ContinuousScheduler
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_lm_generate

    import grpc

    t_phase = time.monotonic()
    S, T, N, Q = SERVE["slots"], SERVE["prompt"], SERVE["new"], SERVE["min_budget"]
    R, C, ST = SERVE["requests"], SERVE["critical"], SERVE["streams"]
    rng = np.random.default_rng(SERVE["seed"])
    rows = np.asarray(eval_rows)
    starts = rng.integers(0, rows.shape[1] - T, R)
    picks = rng.integers(0, len(rows), R)
    reqs = np.stack([rows[r, o:o + T] for r, o in zip(picks, starts)]).astype(np.int32)
    reqs[1:R // 2, :SERVE["shared"]] = reqs[0, :SERVE["shared"]]
    # Every other request rides the RPC (the endpoint's budget, N); the
    # rest go to the scheduler with their own budgets.
    budget = [N if i % 2 == 0 else int(b) for i, b in
              enumerate(rng.integers(SERVE["min_budget"], N, R))]
    on_wire = [i for i in range(R) if i % 2 == 0]
    # The served params: seeded init, the query and key projections at
    # twice their scale (attention logits four times sharper). At the
    # init scale attention averages the context and each prompt goes on
    # with one repeated byte; the LM path's 30-step params emit spaces
    # whatever the prompt. On either, a slot that reads a wrong position
    # or another slot's cache can pass every check below.
    params = init_transformer(torch.Generator().manual_seed(SERVE["seed"]), cfg, device=dev)
    params["blocks"]["w_qkv"][..., :2 * cfg.d_model] *= SERVE["qk_scale"]

    # The probe: every prompt through a scheduler with no eos and no
    # prefix cache, all N tokens, in one submit (check (d)'s off arm).
    probe = ContinuousScheduler(params, cfg, slots=S, prompt_len=T, max_new_tokens=N,
                                prefill_chunk=SERVE["chunk"], device=dev)
    t0 = time.monotonic()
    out_off = probe.submit(reqs)
    off_s = time.monotonic() - t0
    probe.close()
    del probe
    tails = np.asarray(out_off[:, T:])
    eos, n_late, n_early, n_left = pick_eos(tails, budget, Q)
    distinct = len({t[:Q].tobytes() for t in tails})
    print(f"serving probe ({R} prompts, no eos, no prefix cache, one submit, {off_s:.3f} s): "
          f"{distinct} distinct first-{Q}-token continuations of {R}; eos {eos} ends {n_late} "
          f"requests after {Q} tokens and {n_early} sooner, leaves {n_left} to their budgets; "
          f"first continuation {bytes(tails[0, :40].astype(np.uint8).tolist())!r}")
    if distinct <= R // 2 or n_late < 1 or n_left < 1:
        fail(f"serving: the served params' greedy text does not depend on the prompt ({distinct}"
             f" distinct of {R}) or no eos ends some requests and not others")

    def generated(row, b=N):
        """A reply row's generated tokens: through the first eos, at most
        ``b``."""
        tail = np.asarray(row[T:T + b])
        hit = np.flatnonzero(tail == eos)
        return tail[:hit[0] + 1] if hit.size else tail

    t0 = time.monotonic()
    server, port = serve_lm_generate(
        params, cfg, 0, host="127.0.0.1", scheduler="continuous", gen_slots=S, prompt_len=T,
        max_new_tokens=N, prefill_chunk=SERVE["chunk"], prefix_cache_blocks=SERVE["blocks"],
        eos_id=eos, temperature=0.0, warm_rows=1, max_workers=SERVE["rpc_workers"])
    warm_s = time.monotonic() - t0
    sched = server.scheduler
    target = f"127.0.0.1:{port}"
    print(f"LM serving 85M bf16 on {smi_line}: continuous scheduler, {S} slots, prompt {T}, "
          f"{N} new tokens (eos {eos}), prefill chunk {SERVE['chunk']}, {SERVE['blocks']} "
          f"prefix blocks; {num_params(params):,} params (seeded init, seed {SERVE['seed']}, "
          f"q and k x {SERVE['qk_scale']:g}); "
          f"endpoint up and warm (chunk lengths "
          f"{sched._chunk_lengths()}, step captured) in {warm_s:.2f} s")

    errors = []

    def call(out, key, i, cls="standard", stream=False):
        """Load request ``i`` as it rode the load (its RPC, or the
        scheduler with its budget), as class ``cls``: a reply row, or a
        stream's (tokens, terminal)."""
        try:
            if i in on_wire or cls != "standard" or stream:
                c = GrpcClient(target, timeout=300.0, slo_class=cls, retry=None)
                try:
                    if stream:
                        reply = c.generate_stream(reqs[i])
                        out[key] = (list(reply), reply.finish)
                    else:
                        out[key] = c.generate(reqs[i][None])[0]
                finally:
                    c.close()
            else:
                out[key] = sched.submit(reqs[i][None], max_new_tokens=budget[i],
                                        timeout=300.0)[0]
        except grpc.RpcError as e:
            out[key] = e.code().name
        except Exception as e:  # noqa: BLE001 — failed after the join
            errors.append(f"{cls}{' stream' if stream else ''}: {type(e).__name__}: {e}")

    def run_threads(threads):
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    # 1. The load: each of 12 threads sends its next request when its
    # reply lands.
    replies = [None] * R
    queue_idx = iter(range(R))
    qlock = threading.Lock()

    def load_worker():
        while True:
            with qlock:
                i = next(queue_idx, None)
            if i is None:
                return
            call(replies, i, i)

    sched.ttft_recent.clear()
    by_eos = REGISTRY.get("tdn_gen_requests_retired_total").labels(reason="eos")
    eos0 = by_eos.value
    steps0, slot_steps0 = sched.steps_total, sched.slot_steps_total
    chunks0 = sched.prefill_chunks_total
    t0 = time.monotonic()
    run_threads([threading.Thread(target=load_worker) for _ in range(SERVE["threads"])])
    load_s = time.monotonic() - t0
    if errors or any(isinstance(r, str) for r in replies):
        fail(f"serving: load requests failed: {errors[:2]}, "
             f"{[r for r in replies if isinstance(r, str)]}")
    steps = sched.steps_total - steps0
    occupancy = (sched.slot_steps_total - slot_steps0) / max(steps * S, 1)
    lens = [len(generated(replies[i], budget[i])) for i in range(R)]
    ended_eos = sum(eos in np.asarray(replies[i][T:T + budget[i]]) for i in range(R))
    retired_eos = int(by_eos.value - eos0)
    ttft = np.asarray(sched.ttft_recent) * 1e3
    print(f"serving load on {smi_line}: {R} requests ({len(on_wire)} Generate RPCs, "
          f"{R - len(on_wire)} with budgets {min(budget[1::2])}-{max(budget[1::2])}) from "
          f"{SERVE['threads']} threads: {load_s:.3f} s wall, {sum(lens)} tokens ({min(lens)}-"
          f"{max(lens)} a request), {sum(lens) / load_s:.1f} tokens/s; TTFT p50 "
          f"{np.percentile(ttft, 50):.2f} ms, p99 {np.percentile(ttft, 99):.2f} ms ({len(ttft)} "
          f"rows); {steps} steps, slot occupancy {occupancy:.3f}; "
          f"{sched.prefill_chunks_total - chunks0} prefill chunks; prefix hits "
          f"{sched.prefix_hits_total}, misses {sched.prefix_misses_total}, evictions "
          f"{sched.prefix_evictions_total}; first reply {bytes(replies[0][T:T + 40].tolist())!r}")
    ok_eos = retired_eos == ended_eos and 1 <= ended_eos < R
    print(f"check load retirement: {ended_eos} replies end on eos within their budgets, "
          f"{R - ended_eos} at their budgets; the scheduler retired {retired_eos} rows on eos | "
          f"{'ok' if ok_eos else 'FAIL'}")
    if not ok_eos:
        fail("serving: the load did not retire rows both on eos and on their budgets")

    # The reference of every check: each load request alone on the
    # scheduler, with its budget.
    alone = [sched.submit(reqs[i][None], max_new_tokens=budget[i])[0] for i in range(R)]
    longest = sorted(on_wire, key=lambda i: -lens[i])

    # 2. Preemption: the 4 streams (best_effort; the longest RPC
    # requests) bind first, then 12 load requests fill the other slots;
    # once the streams decode with >= 2 tokens, every slot busy, the loop
    # holds at the top of a step until 4 critical requests have queued,
    # so preemption evicts the streams, which resume by re-prefill and
    # forced-token replay.
    victims, victim_tokens = [], []
    real_preempt = sched._preempt_slot

    def spy(slot):
        occ = sched._occupant[slot]
        victims.append(occ["item"]["x"][occ["row"]].tobytes())
        victim_tokens.append(len(occ["tokens"]) + len(occ.get("replay") or ()))
        real_preempt(slot)

    full, release = threading.Event(), threading.Event()

    def hold(_tok):
        occ = sched._occupant
        if full.is_set() or not all(o is not None for o in occ):
            return
        decoding = sum(1 for s_, o in enumerate(occ)
                       if sched._active[s_] and len(o["tokens"]) >= 2
                       and o["item"]["slo_class"] == "best_effort")
        if decoding == ST:
            full.set()
            release.wait(60.0)

    def wait_for(cond, what):
        t1 = time.monotonic()
        while not cond():
            if time.monotonic() - t1 > 60.0:
                fail(f"serving: {what} (occupied {sched.slots_active}, errors {errors[:2]})")
            time.sleep(1e-3)

    stream_idx = longest[:ST]
    # The longest others fill the house: a row that retires on eos
    # before the last one binds leaves a slot free.
    burst_idx = sorted((i for i in range(R) if i not in stream_idx), key=lambda i: -lens[i])
    burst_idx = burst_idx[:S - ST]
    crit_idx = longest[ST:ST + C]
    sched._preempt_slot = spy
    sched.launch_hook = hold
    stream_out, burst, crit_replies = [None] * ST, [None] * (S - ST), [None] * C
    bound0 = sched.rows_total
    streams = [threading.Thread(target=call, args=(stream_out, j, i, "best_effort", True))
               for j, i in enumerate(stream_idx)]
    for th in streams:
        th.start()
    wait_for(lambda: sched.rows_total - bound0 >= ST, "the streams never bound")
    others = [threading.Thread(target=call, args=(burst, k, i)) for k, i in enumerate(burst_idx)]
    for th in others:
        th.start()
    if not full.wait(60.0):
        fail(f"serving: the streams never decoded in a full house (occupied "
             f"{sched.slots_active}, errors {errors[:2]})")
    crits = [threading.Thread(target=call, args=(crit_replies, j, i, "critical"))
             for j, i in enumerate(crit_idx)]
    for th in crits:
        th.start()
    wait_for(lambda: sched.pending_rows >= C, "the critical requests never queued")
    release.set()
    for th in streams + others + crits:
        th.join()
    sched.launch_hook = None
    sched._preempt_slot = real_preempt
    if errors:
        fail(f"serving: {len(errors)} requests failed, first: {errors[0]}")
    preempted = sched.preempted_total
    print(f"serving preemption: {ST} best_effort streams + {S - ST} load requests (of "
          f"{min(lens[i] for i in burst_idx)}-{max(lens[i] for i in burst_idx)} tokens) in {S} "
          f"slots, {C} critical Generate RPCs sent while every slot was busy: preemptions "
          f"{preempted}, generated tokens at eviction {victim_tokens}")

    # (a) every reply bit-equal to its prompt's run alone; (c) the
    # preempted streams; (e) the streams against the unary reply.
    diff_a = [f"load {i}" for i in range(R) if not np.array_equal(replies[i], alone[i])]
    diff_a += [f"burst {i}" for k, i in enumerate(burst_idx) if not np.array_equal(burst[k],
                                                                                  alone[i])]
    diff_a += [f"critical {i}" for j, i in enumerate(crit_idx)
               if not np.array_equal(crit_replies[j], alone[i])]
    n_a = R + S - ST + C
    ok_a = not diff_a
    print(f"check (a) {n_a} greedy replies bit-equal to the scheduler's output for each prompt "
          f"alone: {n_a - len(diff_a)} equal | {'ok' if ok_a else 'FAIL'}")
    streamed = {reqs[i].tobytes(): (stream_out[j][0], alone[i]) for j, i in enumerate(stream_idx)}
    ok_c = (preempted >= 1 and len(victims) == preempted
            and all(v in streamed and streamed[v][0] == generated(streamed[v][1]).tolist()
                    for v in victims))
    print(f"check (c) {len(victims)} preempted rows (the best_effort streams, generated tokens "
          f"at eviction {victim_tokens}) equal to their unpreempted runs | "
          f"{'ok' if ok_c else 'FAIL'}")
    diff_e = [j for j, i in enumerate(stream_idx)
              if stream_out[j][0] != generated(replies[i]).tolist()
              or stream_out[j][1]["reason"] not in ("eos", "max_tokens")]
    ok_e = not diff_e
    print(f"check (e) {ST} GenerateStream token lists equal to the unary reply, each token once: "
          f"{ST - len(diff_e)} equal ({[len(t) for t, _ in stream_out]} tokens, terminals "
          f"{[f['reason'] for _, f in stream_out]}) | {'ok' if ok_e else 'FAIL'}")
    if not (ok_a and ok_c and ok_e):
        fail(f"serving: (a) {diff_a}, (c) {ok_c}, (e) {diff_e}")

    # (b) each emitted token against the argmax of the full forward over
    # the prompt and the tokens before it (materialised attention, bf16).
    seqs = torch.as_tensor(np.stack(replies), device=dev).long()
    with torch.no_grad():
        logits = forward(params, seqs[:, :-1], cfg).float()
    worst, n_off, n_checked = 0.0, 0, 0
    for i in range(R):
        gen = generated(replies[i], budget[i])
        lg = logits[i, T - 1:T - 1 + len(gen)]
        picked = lg.gather(1, torch.as_tensor(gen, device=dev).long()[:, None])[:, 0]
        gaps = (lg.max(dim=1).values - picked).cpu().numpy()
        worst = max(worst, float(gaps.max()))
        n_off += int((gaps > 0).sum())
        n_checked += len(gen)
    ok_b = worst <= SERVE["logit_tol"]
    print(f"check (b) {n_checked} emitted tokens vs the argmax of the full forward (bf16): "
          f"{n_off} not its argmax, largest logit gap {worst:.4f} | tol gap <= "
          f"{SERVE['logit_tol']} (bf16 rounding of logits up to 32 is 0.125, two paths) | "
          f"{'ok' if ok_b else 'FAIL'}")
    if not ok_b:
        fail("serving: an emitted token is not the full forward's argmax within bf16 tolerance")
    del logits

    # (g) a NaN forced into one slot's logits through the fetch_hook seam
    # (its cache's key at position 0 of layer 0, once the row decodes):
    # that request alone fails DATA_LOSS, its 3 neighbours as alone.
    guard_idx = longest[:4]  # the victim first: it must decode >= 2 tokens
    victim = reqs[guard_idx[0]].tobytes()
    poisoned = []

    def poison(_toks):
        if poisoned:
            return
        for s_, occ in enumerate(sched._occupant):
            if (occ is not None and sched._active[s_] and len(occ["tokens"]) >= 2
                    and occ["item"]["x"][occ["row"]].tobytes() == victim):
                sched._cache["k"][0, s_, 0].fill_(float("nan"))
                poisoned.append(s_)

    sched.fetch_hook = poison
    got_g = [None] * 4
    run_threads([threading.Thread(target=call, args=(got_g, j, i))
                 for j, i in enumerate(guard_idx)])
    sched.fetch_hook = None
    same_g = all(np.array_equal(got_g[j], alone[i]) for j, i in enumerate(guard_idx) if j)
    ok_g = bool(poisoned) and got_g[0] == "DATA_LOSS" and same_g and not errors
    print(f"check (g) NaN forced into slot {poisoned} through fetch_hook: the victim "
          f"{got_g[0] if isinstance(got_g[0], str) else 'served'}, its 3 neighbours bit-equal "
          f"to their alone runs {same_g} | {'ok' if ok_g else 'FAIL'}")
    if not ok_g:
        fail("serving: the decode-step guard did not fail the poisoned slot alone")
    server.stop(0)
    if not server.join_closed(30.0):
        fail("serving: the scheduler's loop did not stop")

    # (d) prefix cache off (the probe: no eos either, cut at eos here),
    # everything else equal: the same tokens.
    diff_d = sum(not np.array_equal(generated(out_off[i], budget[i]),
                                    generated(replies[i], budget[i])) for i in range(R))
    print(f"check (d) prefix cache off (the probe's {R} rows, cut at eos {eos}) bit-equal to on: "
          f"{R - diff_d} equal | {'ok' if diff_d == 0 else 'FAIL'}")
    if diff_d:
        fail("serving: prefix-cache-on replies differ from prefix-cache-off")
    # (f) the captured step against the eager step on one slot state:
    # staggered positions, slot 3 inactive (the loop has stopped).
    st = sched._st
    for k in st.cache:  # (g)'s NaN stays out of the comparison
        for s_ in poisoned:
            st.cache[k][:, s_].zero_()
    h = sched._inp_host.numpy()
    h[0] = T + 7 * np.arange(S)
    h[1] = 1
    h[1, 3] = 0
    h[2] = rng.integers(0, cfg.vocab_size, S)
    st.inp.copy_(sched._inp_host)
    saved = {k: v.clone() for k, v in st.cache.items()}
    sched._run_step(graphed=False)
    res_e = st.res.clone()
    cache_e = {k: v.clone() for k, v in st.cache.items()}
    for k in st.cache:
        st.cache[k].copy_(saved[k])
    sched._run_step(graphed=True)
    ok_f = torch.equal(st.res, res_e) and all(torch.equal(st.cache[k], cache_e[k])
                                              for k in st.cache)
    print(f"check (f) the captured step bit-equal to the eager step (tokens, ok and the "
          f"({cfg.n_layers}, {S + SERVE['blocks']}, {T + N - 1}, {cfg.n_heads}, "
          f"{cfg.head_dim}) cache; staggered positions, slot 3 inactive) | "
          f"{'ok' if ok_f else 'FAIL'}")
    if not ok_f:
        fail("serving: the captured scheduler step differs from the eager step")
    del saved, cache_e

    # Decode ms/step, graphed and eager in turns; a prefill chunk's time.
    ms = {"eager": [], "graphed": []}
    for arm in ("eager", "graphed", "graphed", "eager"):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(SERVE["step_runs"]):
            sched._run_step(graphed=arm == "graphed")
        b.record()
        b.synchronize()
        ms[arm].append(a.elapsed_time(b) / SERVE["step_runs"])
    chunk = torch.as_tensor(reqs[:1, :SERVE["chunk"]], device=dev)
    with torch.no_grad():
        prefill_chunk_into_cache(sched._params, cfg, st.cache, 0, chunk, 0)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(SERVE["chunk_runs"]):
            prefill_chunk_into_cache(sched._params, cfg, st.cache, 0, chunk, 0)
        b.record()
        b.synchronize()
    chunk_ms = a.elapsed_time(b) / SERVE["chunk_runs"]
    g, e = float(np.median(ms["graphed"])), float(np.median(ms["eager"]))
    print(f"serving decode step ({S} slots, cache {T + N - 1}) on {smi_line}: graphed "
          f"{g:.4f} ms/step, eager {e:.4f} ms/step (runs of {SERVE['step_runs']}: graphed "
          f"{json.dumps([round(x, 4) for x in ms['graphed']])}, eager "
          f"{json.dumps([round(x, 4) for x in ms['eager']])}), {e / g:.2f}x; "
          f"{S / g * 1e3:.1f} tokens/s at full occupancy; prefill chunk of {SERVE['chunk']} "
          f"tokens (all {T + N - 1} rows of its slot) {chunk_ms:.3f} ms")
    st = None
    sched = None
    torch.cuda.empty_cache()

    # The static arm on the same 24 prompts (printed only: JAX bench.py
    # --gen-ab's A/B).
    sserver, sport = serve_lm_generate(params, cfg, 0, host="127.0.0.1", scheduler="static",
                                       prompt_len=T, max_new_tokens=N, eos_id=eos,
                                       temperature=0.0, warm_rows=16,
                                       max_workers=SERVE["rpc_workers"])
    lat = [0.0] * R
    sreplies = [None] * R
    queue_idx = iter(range(R))

    def static_worker():
        c = GrpcClient(f"127.0.0.1:{sport}", timeout=300.0)
        try:
            while True:
                with qlock:
                    i = next(queue_idx, None)
                if i is None:
                    return
                t1 = time.monotonic()
                sreplies[i] = c.generate(reqs[i:i + 1])[0]
                lat[i] = time.monotonic() - t1
        except Exception as e:  # noqa: BLE001
            errors.append(f"static: {type(e).__name__}: {e}")
        finally:
            c.close()

    t0 = time.monotonic()
    ths = [threading.Thread(target=static_worker) for _ in range(SERVE["threads"])]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    static_s = time.monotonic() - t0
    sserver.stop(0)
    sserver.join_closed(30.0)
    if errors:
        fail(f"serving static arm: {errors[0]}")
    # Its useful tokens: each request's own budget (the run-to-completion
    # batch decodes all N for everyone).
    s_tok = sum(len(generated(r, b)) for r, b in zip(sreplies, budget))
    same = sum(np.array_equal(generated(sreplies[i], budget[i]), generated(replies[i], budget[i]))
               for i in range(R))
    lat_ms = np.asarray(lat) * 1e3
    print(f"static arm (run to completion, same {R} requests, {SERVE['threads']} threads) on "
          f"{smi_line}: {static_s:.3f} s wall, {s_tok} tokens within the budgets, "
          f"{s_tok / static_s:.1f} tokens/s; "
          f"TTFT (= latency) p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.2f} ms; replies equal to the continuous ones {same} of "
          f"{R} (bf16, other GEMM shapes: printed only)")
    torch.cuda.empty_cache()
    print(f"serving phase took {time.monotonic() - t_phase:.1f} s")


# The model-parallel LM (BASELINE configs[4]'s deployment shape): the
# per-block pipeline and the Megatron split over stage and model slots of
# one card, in training and in decode. The steps' constant lr is small
# enough that Adam's first sign-like updates lower the loss from this
# init (at 3e-4 without warm-up it first rises to ~9.5 nats).
MP = dict(stages=4, model=2, micro=4, il_stages=2, il_virtual=3, zbv_stages=3, steps=4, lr=5e-5,
          seed=11,
          groups=4, group_rows=4, prompt=128, new=32, near_tie=0.25, requests=8, threads=4,
          spread_factor=4.0, qk_scale=2.0)


def model_parallel_phase(dev, cfg, train_rows, eval_rows, out_dir, smi_line) -> None:
    """The 85M LM (``cfg``: bf16, remat) through the model-parallel paths
    on stage x model slots of one card (cut from a multi-chip mesh):

    * training: the first step's loss and gradients of gpipe, 1f1b and zb
      at stage 4 x model 2 (3 blocks a stage), of interleaved at 2 stages
      x 3 virtual x 2 model (2 blocks a chunk), of zb-v at 3 stages x 2
      model (the V's 6 chunks of 2 blocks: 12 layers need ``n_layers %
      2S == 0``) and of zb-stash at stage 4 x model 1 (dense only), 4
      microbatches of 4 rows, against the reference: the single bf16
      program from the same weights run over the same 4 microbatches,
      each loss / 4 and the gradients summed in the float32 leaves, as
      the pipeline sums them. The tolerance is ``MP["spread_factor"]``
      times that reference's own bf16 spread, a leaf (its distance from
      the same microbatched step with the materialised attention; at
      least 2**-8); the loss's at least the bf16 parity check's
      first-step rtol. gpipe against 1f1b at
      tests/test_pipeline_1f1b.py's tolerance; each other schedule's
      distance from 1f1b printed, and each table's ``bubble_ticks``.
      Then ``MP["steps"]`` steps of each schedule eager, through
      ``make_pipeline_lm_train_step``: finite, falling losses, each
      step's loss within the loss tolerance of the single program's at
      the same step (the same batches and optimizer), each step timed
      with CUDA events (p50 beside the eager single program's), and the
      sm90 flash pair the only attention launched, counted a step: a
      (block, microbatch, model slot) costs 2 forwards and 1 backward
      under remat (3 and 2 for zb and zb-v, but chunk 0's blocks 2 and
      1: see (b)), and no flash kernel runs inside a zb-stash W op; and
      the same steps graphed through ``train_lm`` (the step captured on
      the card's slots), losses and trained params bit-equal to the
      eager steps', with the launches of every replay, step p50 beside
      the eager one and the graphed single program's;
    * decode, on seeded init params with q and k x ``MP["qk_scale"]`` (so
      the greedy text depends on the prompt, as the serving phase's):
      ``make_pipeline_generate_overlapped`` at 4 stages and 4 groups of 4
      rows (128-byte held-out prompts, 32 greedy tokens) token for token
      the single program's ``generate`` of each group; ``tp_generate`` at
      model 2 on the 16 prompts the same, or, where a row differs, the
      reference's top-2 logit gap at its first differing step under
      ``MP["near_tie"]``; ``serve_lm_generate(num_stages=4)`` over
      loopback gRPC answering 8 ``Generate`` requests from 4 threads,
      each reply the overlapped decoder's tokens for that prompt; the
      tokens/s of each decoder. Every check is fatal."""
    import threading

    import numpy as np
    import torch

    from tpu_dist_nn_torch.data.text import lm_batches
    from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
    from tpu_dist_nn_torch.models.generate import generate
    from tpu_dist_nn_torch.models.transformer import (
        dot_product_attention,
        forward,
        init_transformer,
        lm_loss,
        param_leaves,
        tree_map,
    )
    from tpu_dist_nn_torch.kernels import flash_bwd_sm90, flash_fwd_sm90
    from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.one_f_one_b import schedule_tables
    from tpu_dist_nn_torch.parallel.pp_generate import make_pipeline_generate_overlapped
    from tpu_dist_nn_torch.parallel.tensor_parallel import tp_shard_blocks
    from tpu_dist_nn_torch.parallel.tp_generate import tp_generate
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_lm_generate
    from tpu_dist_nn_torch.train.lm_trainer import (
        LMTrainConfig,
        lm_block_layout,
        make_lm_train_step,
        make_pipeline_lm_train_step,
        train_lm,
    )
    from tpu_dist_nn_torch.train.optimizers import build_optimizer

    t_phase = time.monotonic()
    S, NT, M, L, B = MP["stages"], MP["model"], MP["micro"], cfg.n_layers, LM["batch"]

    def mesh(stage=1, model=1):
        return build_mesh(MeshSpec(stage=stage, model=model), [dev] * (stage * model))

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

    params = init_transformer(torch.Generator().manual_seed(MP["seed"]), cfg, device=dev)
    stream = lm_batches(train_rows, B, seed=MP["seed"], epochs=None)
    batches = [torch.as_tensor(next(stream), device=dev).long() for _ in range(MP["steps"])]
    tokens = batches[0]

    # (a) the reference: the single bf16 program over the pipeline's
    # microbatches, its loss / M each and its gradients summed in the
    # float32 leaves, with the flash pair and with the materialised
    # attention (its own bf16 spread). The full-batch step in bf16 and in
    # float32 is printed beside it: its tok_embed gradient, rounded to bf16
    # once for the whole batch and not once a microbatch, reads ~8e-2
    # relative L2 from the microbatched one on the card, its other leaves
    # ~2e-3.
    def first_step(c, attn, parts):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        loss = 0.0
        for mb in tokens.chunk(parts):
            part = lm_loss(p, mb, c, attn) / parts
            part.backward()
            loss += float(part.detach())
        return loss, [a.grad for a in param_leaves(p)]

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ref = {"flash": first_step(cfg, flash_attention, M),
           "dot_product": first_step(cfg, dot_product_attention, M),
           "full batch": first_step(cfg, flash_attention, 1),
           "float32": first_step(cfg32, flash_attention, 1)}
    torch.cuda.empty_cache()
    names = [name for name, _ in _named_leaves(params)]
    loss_ref, g_ref = ref["flash"]
    g_full, g32 = ref["full batch"][1], ref["float32"][1]
    spread_loss = abs(ref["dot_product"][0] - loss_ref) / abs(loss_ref)
    spread = {n: rel(a, b) for n, a, b in zip(names, ref["dot_product"][1], g_ref)}
    tol_loss = max(MP["spread_factor"] * spread_loss, BF16_PARITY_RTOL[0])
    # each leaf's: floored at one bf16 rounding (2**-8); a wrong shard or
    # hand-off moves a gradient by its own size
    tol_g = {n: max(MP["spread_factor"] * e, 2.0**-8) for n, e in spread.items()}
    print(f"model parallel: 85M bf16 remat on {smi_line}; reference step 1 (single program "
          f"over {M} microbatches): loss {loss_ref!r} (materialised attention "
          f"{ref['dot_product'][0]!r}: rel {spread_loss:.3e}; full batch "
          f"{ref['full batch'][0]!r}, float32 {ref['float32'][0]!r}); gradient spread flash "
          f"vs materialised, relative L2 a leaf: "
          f"{json.dumps({n: float(f'{e:.3e}') for n, e in spread.items()})} -> tolerances: "
          f"loss rtol {tol_loss:.3e}, each leaf's relative L2 {MP['spread_factor']:g} x its "
          f"spread (at least 2**-8); the full-batch bf16 step's distance from the reference: "
          f"{json.dumps({n: float(f'{rel(a, b):.3e}') for n, a, b in zip(names, g_full, g_ref)})}")
    del ref

    # (b) each schedule's first step against the reference. Flash
    # launches a step (remat, bf16), a (block, microbatch, model shard)
    # each: the combined backward and zb-stash 2 forwards and 1 backward
    # (zb-stash: the FWD op without a graph, then B's one forward keeping
    # the sub-op vjps and its backward; W none); zb and zb-v 3 and 2 (B
    # and W each recompute the checkpointed block and run its backward),
    # but chunk 0, which has no input cotangent and so no backward in B:
    # 2 and 1.
    SCHEDULES = (("gpipe", S, 1, NT), ("1f1b", S, 1, NT),
                 ("interleaved", MP["il_stages"], MP["il_virtual"], NT),
                 ("zb", S, 1, NT), ("zb-v", MP["zbv_stages"], 2, NT), ("zb-stash", S, 1, 1))

    def make_vag(sched, stages, v, nt):
        m = mesh(stages, nt)
        return {"gpipe": lambda: tpl.make_pipeline_tp_lm_gpipe_grad(m, cfg, stages, M),
                "1f1b": lambda: tpl.make_pipeline_tp_lm_1f1b_grad(m, cfg, stages, M),
                "interleaved": lambda: tpl.make_pipeline_tp_lm_interleaved_grad(m, cfg, v, M),
                "zb": lambda: tpl.make_pipeline_tp_lm_zb_grad(m, cfg, v, M),
                "zb-v": lambda: tpl.make_pipeline_tp_lm_zb_v_grad(m, cfg, M),
                "zb-stash": lambda: tpl.make_pipeline_lm_zb_stash_grad(m, cfg, v, M)}[sched]()

    def want_launches(sched, stages, v, nt):
        if sched in ("zb", "zb-v"):
            first = L // (stages * v)  # chunk 0's blocks
            return (3 * L - first) * M * nt, (2 * L - first) * M * nt
        return 2 * L * M * nt, L * M * nt

    def label_of(sched, stages, v, nt):
        return (f"{sched} stage {stages}" + (f" x virtual {v}" if v > 1 else "")
                + f" x model {nt}, {M} microbatches")

    def only_sm90(launched, want):
        return ((launched["flash_fwd_sm90"], launched["flash_bwd_sm90"]) == want
                and sum(n for k, n in launched.items() if not k.endswith("_sm90")) == 0)

    # zb-stash's W ops: the flash launches inside each (none allowed)
    w_flash = []
    stash_w = tpl.StashSplit.backward_w

    def counted_w(self, d, c, wstash):
        before = flash_fwd_sm90.launches + flash_bwd_sm90.launches
        stash_w(self, d, c, wstash)
        w_flash.append(flash_fwd_sm90.launches + flash_bwd_sm90.launches - before)

    tpl.StashSplit.backward_w = counted_w
    got = {}
    for sched, stages, v, nt in SCHEDULES:
        shard, unshard = lm_block_layout(sched, stages, v, cfg=cfg, tp=nt)
        staged = dict(params, blocks=shard(params["blocks"]))
        vag = make_vag(sched, stages, v, nt)
        tables = schedule_tables(sched, stages, v, M)
        torch.cuda.synchronize()
        reset_launch_counts()
        w_flash.clear()
        loss, grads = vag(staged, tokens)
        torch.cuda.synchronize()
        launched = counts()
        flat = param_leaves(dict(grads, blocks=unshard(grads["blocks"])))
        got[sched] = (float(loss), flat)
        errs = {n: rel(a, b) for n, a, b in zip(names, flat, g_ref)}
        share = {n: errs[n] / tol_g[n] for n in names}
        lrel = abs(float(loss) - loss_ref) / abs(loss_ref)
        want = want_launches(sched, stages, v, nt)
        w_ok = sched != "zb-stash" or (len(w_flash) == tables.num_chunks * M
                                       and not any(w_flash))
        ok = lrel <= tol_loss and max(share.values()) <= 1.0 and only_sm90(launched, want) and w_ok
        worst = max(share, key=share.get)
        label = label_of(sched, stages, v, nt)
        print(f"  model parallel {sched} gradients' relative L2 from the float32 full-batch "
              f"step (the reference's in brackets): " + ", ".join(
                  f"{n} {rel(a, f):.3e} ({rel(b, f):.3e})"
                  for n, a, b, f in zip(names, flat, g_ref, g32)))
        tick = ("" if tables is None else
                f"; tables: {tables.ticks} ticks, bubble_ticks {tables.bubble_ticks}")
        w_note = ("" if sched != "zb-stash" else
                  f"; W ops {len(w_flash)}, flash launches inside them {sum(w_flash)}")
        print(f"check model parallel {label}, step 1 vs the reference: loss {float(loss)!r} "
              f"(rel {lrel:.3e}); gradients' relative L2 "
              f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})}, largest share "
              f"of its tolerance {share[worst]:.3f} ({worst}); launches "
              f"{json.dumps({k: n for k, n in launched.items() if n})}, expected flash_fwd_sm90 "
              f"{want[0]} flash_bwd_sm90 {want[1]} and nothing else{w_note}{tick} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"model parallel {sched}: the first step departs from the single program, "
                 f"launched other attention or flash inside a W op")
        del grads, staged
    g_close = all(torch.allclose(a, b, rtol=2e-4, atol=1e-6)
                  for a, b in zip(got["gpipe"][1], got["1f1b"][1]))
    same = sum(int((a != b).sum()) for a, b in zip(got["gpipe"][1], got["1f1b"][1]))
    l_close = abs(got["gpipe"][0] - got["1f1b"][0]) <= 1e-5 * abs(got["gpipe"][0])
    print(f"check model parallel 1f1b vs gpipe (step 1): loss {got['1f1b'][0]!r} vs "
          f"{got['gpipe'][0]!r}; gradient elements not bit-equal {same} | tol loss rtol 1e-5, "
          f"gradients rtol 2e-4 atol 1e-6 | {'ok' if g_close and l_close else 'FAIL'}")
    if not (g_close and l_close):
        fail("model parallel: 1f1b and gpipe disagree")
    for sched in ("interleaved", "zb", "zb-v", "zb-stash"):
        print(f"model parallel {sched} vs 1f1b (step 1): loss {got[sched][0]!r} vs "
              f"{got['1f1b'][0]!r}; gradients' relative L2 " + json.dumps(
                  {n: float(f"{rel(a, b):.3e}")
                   for n, a, b in zip(names, got[sched][1], got["1f1b"][1])}))
    del got, g_ref, g_full, g32
    torch.cuda.empty_cache()

    # (c) steps of each schedule, eager (timed with CUDA events) and
    # graphed (``train_lm`` captures the step on one card's slots; a
    # step's host time from its history), bit-equal to each other
    def timed_steps(step, state, label):
        losses, ms, per_step = [], [], None
        for i, toks in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                reset_launch_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = step(*state, toks)[2]
            e1.record()
            torch.cuda.synchronize()
            if i == 1:
                per_step = counts()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
        p50 = float(np.median(ms[1:]))
        print(f"model parallel {label}: losses {losses}; step ms {[round(t, 3) for t in ms]} "
              f"(the first includes warm-up); p50 of steps 2-{len(ms)} {p50:.3f} ms, "
              f"{B * LM['seq_len'] / p50 * 1e3:.1f} tokens/s")
        return losses, p50, per_step

    host_batches = [b.cpu().numpy() for b in batches]
    n_steps = len(host_batches)
    train_cfg = LMTrainConfig(learning_rate=MP["lr"], steps=n_steps, batch_size=B,
                              seq_len=LM["seq_len"], log_every=1)

    def graphed_run(label, **pipeline):
        torch.cuda.synchronize()
        reset_launch_counts()
        trained, hist = train_lm(params, cfg, host_batches, train_cfg, **pipeline)
        torch.cuda.synchronize()
        launched = counts()
        ms = [1e3 * (b["seconds"] - a["seconds"]) for a, b in zip(hist, hist[1:])]
        p50 = float(np.median(ms))
        print(f"model parallel {label} graphed (train_lm): losses {[h['loss'] for h in hist]}; "
              f"step ms (host clock, a float(loss) a step) {[round(t, 3) for t in ms]} after "
              f"the first (warm-up and capture, {1e3 * hist[0]['seconds']:.1f} ms); p50 "
              f"{p50:.3f} ms, {B * LM['seq_len'] / p50 * 1e3:.1f} tokens/s")
        gc.collect()
        torch.cuda.empty_cache()
        return trained, [h["loss"] for h in hist], p50, launched

    single = tree_map(lambda a: a.clone().requires_grad_(True), params)
    opt = build_optimizer(MP["lr"], total_steps=n_steps)
    single_losses, single_p50, _ = timed_steps(make_lm_train_step(cfg, opt),
                                               (single, opt.init(param_leaves(single))),
                                               "single program eager (one stream)")
    del single
    torch.cuda.empty_cache()
    _, _, single_graphed_p50, _ = graphed_run("single program")
    p50s = {}
    for sched, stages, v, nt in SCHEDULES:
        shard, unshard = lm_block_layout(sched, stages, v, cfg=cfg, tp=nt)
        st = tree_map(lambda a: a.detach().clone(), dict(params, blocks=shard(params["blocks"])))
        opt = build_optimizer(MP["lr"], total_steps=n_steps)
        m = mesh(stages, nt)
        step = make_pipeline_lm_train_step(m, cfg, stages, M, opt, schedule=sched,
                                           num_virtual=v, tensor_parallel=nt)
        label = label_of(sched, stages, v, nt)
        w_flash.clear()
        losses, p50, per_step = timed_steps(step, (st, opt.init(param_leaves(st))), label)
        eager_params = param_leaves(dict(st, blocks=unshard(st["blocks"])))
        del st, step
        torch.cuda.empty_cache()
        steps_rel = [abs(a - b) / abs(b) for a, b in zip(losses, single_losses)]
        want = want_launches(sched, stages, v, nt)
        ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
              and max(steps_rel) <= tol_loss and only_sm90(per_step, want))
        print(f"check model parallel {sched}: finite, falling losses; each step's loss vs the "
              f"single program's, rel {json.dumps([float(f'{e:.3e}') for e in steps_rel])} "
              f"(tol rtol {tol_loss:.3e}); one step's launches "
              f"{json.dumps({k: n for k, n in per_step.items() if n})} (expected "
              f"flash_fwd_sm90 {want[0]}, flash_bwd_sm90 {want[1]}); p50 {p50:.3f} ms vs the "
              f"single program's eager {single_p50:.3f} ms ({p50 / single_p50:.2f}x) | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"model parallel {sched}: losses not finite and falling, away from the single "
                 f"program's, or other attention launched")
        trained, g_losses, g_p50, g_launched = graphed_run(
            label, mesh=m, num_stages=stages, num_microbatches=M, schedule=sched,
            num_virtual=v, tensor_parallel=nt)
        differ = sum(int((a != b).sum()) for a, b in zip(param_leaves(trained), eager_params))
        total = (want[0] * n_steps, want[1] * n_steps)
        ok = (g_losses == losses and differ == 0 and only_sm90(g_launched, total)
              and not any(w_flash))
        p50s[sched] = (p50, g_p50)
        print(f"check model parallel {sched} graphed vs eager over {n_steps} steps: losses "
              f"bit-equal {g_losses == losses}; trained parameter elements not bit-equal "
              f"{differ}; launches {json.dumps({k: n for k, n in g_launched.items() if n})} "
              f"(expected {total[0]} + {total[1]}); step p50 graphed {g_p50:.3f} ms, eager "
              f"{p50:.3f} ms ({p50 / g_p50:.2f}x), the graphed single program "
              f"{single_graphed_p50:.3f} ms ({g_p50 / single_graphed_p50:.2f}x it) | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"model parallel {sched}: the graphed step departs from the eager one")
        del trained, eager_params
        torch.cuda.empty_cache()
    tpl.StashSplit.backward_w = stash_w
    print("model parallel step p50 ms, eager / graphed (graphed single program "
          f"{single_graphed_p50:.3f}): " + json.dumps(
              {k: [round(e, 3), round(g, 3)] for k, (e, g) in p50s.items()}))

    # (d) decode, on sharper-attention params
    dparams = init_transformer(torch.Generator().manual_seed(MP["seed"]), cfg, device=dev)
    dparams["blocks"]["w_qkv"][..., :2 * cfg.d_model] *= MP["qk_scale"]
    G, Bg, T, N = MP["groups"], MP["group_rows"], MP["prompt"], MP["new"]
    rng = np.random.default_rng(MP["seed"])
    rows = np.asarray(eval_rows)
    starts, picks = rng.integers(0, rows.shape[1] - T, G * Bg), rng.integers(0, len(rows), G * Bg)
    prompts = torch.as_tensor(np.stack([rows[r, o:o + T] for r, o in zip(picks, starts)]),
                              device=dev).long()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    generate(dparams, cfg, prompts, N)  # the graph's capture
    ref16, single_s = timed(lambda: generate(dparams, cfg, prompts, N))
    m4 = mesh(S)
    staged4 = dict(dparams, blocks=tpl.shard_blocks(dparams["blocks"], S))
    over = make_pipeline_generate_overlapped(m4, cfg, S, N, G)
    grouped = prompts.reshape(G, Bg, T)
    over(staged4, grouped)  # warm
    out_o, over_s = timed(lambda: over(staged4, grouped))
    refs = [generate(dparams, cfg, grouped[g], N) for g in range(G)]
    diff_o = sum(int((out_o[g, :, T:] != refs[g]).sum()) for g in range(G))
    distinct = len({bytes(r[:16].tolist()) for r in ref16.cpu().numpy().astype(np.uint8)})
    ok = diff_o == 0 and bool((out_o[:, :, :T] == grouped).all()) and distinct > G * Bg // 2
    print(f"check model parallel decode: make_pipeline_generate_overlapped {S} stages x {G} "
          f"groups of {Bg} rows, prompt {T}, {N} greedy tokens vs generate of each group: "
          f"tokens not equal {diff_o}; {distinct} distinct first-16-token continuations of "
          f"{G * Bg} | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("model parallel: the overlapped pipelined decode differs from the single program")
    print(f"model parallel decode tokens/s ({G * Bg} rows x {N} tokens): overlapped pipeline "
          f"{G * Bg * N / over_s:.1f} ({over_s:.3f} s), single program generate (graphed) "
          f"{G * Bg * N / single_s:.1f} ({single_s:.3f} s)")

    mtp = mesh(model=NT)
    ptp = dict(dparams, blocks=tp_shard_blocks(dparams["blocks"], cfg, NT))
    tp_generate(mtp, ptp, cfg, prompts, N)  # warm
    out_t, tp_s = timed(lambda: tp_generate(mtp, ptp, cfg, prompts, N))
    print(f"model parallel decode tokens/s: tp_generate model {NT} "
          f"{G * Bg * N / tp_s:.1f} ({tp_s:.3f} s)")
    worst = 0.0
    bad_rows = []
    for r in range(G * Bg):
        where = torch.nonzero(out_t[r] != ref16[r])
        if not len(where):
            continue
        j = int(where[0])
        seq = torch.cat([prompts[r], ref16[r, :j]])[None]
        with torch.no_grad():
            top2 = forward(dparams, seq, cfg)[0, -1].float().topk(2).values
        gap = float(top2[0] - top2[1])
        worst = max(worst, gap)
        print(f"  tp_generate row {r} first differs at step {j}: reference top-2 logit gap "
              f"{gap:.4f} (near-tie bound {MP['near_tie']})")
        if gap >= MP["near_tie"]:
            bad_rows.append(r)
    n_diff = sum(bool((out_t[r] != ref16[r]).any()) for r in range(G * Bg))
    ok = not bad_rows
    print(f"check model parallel tp_generate model {NT} vs generate: {n_diff} of {G * Bg} rows "
          f"differ, every first difference at a near tie (largest gap {worst:.4f} < "
          f"{MP['near_tie']}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"model parallel: tp_generate rows {bad_rows} differ from generate away from a tie")

    # the pipelined overlapped decoder behind Generate
    import grpc  # noqa: F401 — the serving phase needs it too

    reqs = prompts[:MP["requests"]]
    ref_one = []
    for k in range(0, MP["requests"], G):  # 4 prompts at a time, a group of one row each
        ref_one.append(over(staged4, reqs[k:k + G][:, None, :])[:, 0, T:])
    ref_one = torch.cat(ref_one).cpu().numpy()
    server, port = serve_lm_generate(dparams, cfg, 0, host="127.0.0.1", max_new_tokens=N,
                                     prompt_len=T, num_stages=S, num_groups=G, temperature=0.0,
                                     device=dev)
    replies = [None] * MP["requests"]
    errors = []
    host_reqs = reqs.cpu().numpy()

    def worker(w):
        client = GrpcClient(f"127.0.0.1:{port}", timeout=300.0)
        try:
            for i in range(w, MP["requests"], MP["threads"]):
                replies[i] = client.generate(host_reqs[i:i + 1])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            client.close()

    t0 = time.monotonic()
    pool = [threading.Thread(target=worker, args=(w,)) for w in range(MP["threads"])]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    serve_s = time.monotonic() - t0
    batches_total = server.batcher.batches_total
    server.stop(0)
    diff_s = sum(int((np.asarray(rep)[0, T:] != ref_one[i]).sum()) if rep is not None else N
                 for i, rep in enumerate(replies))
    ok = not errors and diff_s == 0
    print(f"check model parallel serving: serve_lm_generate(num_stages={S}, num_groups={G}) "
          f"over loopback gRPC, {MP['requests']} Generate requests of 1 row from "
          f"{MP['threads']} threads in {batches_total} launches, {serve_s:.3f} s "
          f"({MP['requests'] * N / serve_s:.1f} tokens/s); replies' tokens not equal to the "
          f"overlapped decoder's {diff_s}; errors {errors} | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("model parallel: the pipelined Generate endpoint's replies differ")
    del dparams, staged4, ptp
    torch.cuda.empty_cache()
    print(f"model parallel phase: {time.monotonic() - t_phase:.1f} s")


# Sequence parallelism (the long-context member of BASELINE configs[4]'s
# parallelism family): ring and Ulysses attention over seq slots of one
# card, alone, through the pipeline and with the Megatron split, on the
# 85M LM. Rows of 1,024 tokens (a 1,023-token forward plus its target)
# fit the 1,024-row position table, as sp's seq_len + 1 must.
SP = dict(micro=4, steps=4, lr=5e-5, seed=13, seq=4, pp_seq=2, stages=4, model=2,
          il_stages=2, il_virtual=3, zbv_stages=3)


def seq_parallel_phase(dev, cfg, text, out_dir, smi_line) -> None:
    """The 85M LM (``cfg``: bf16, remat) through sequence parallelism on
    slots of one card (cut from a multi-chip mesh):

    * step 1 of each arm against the single bf16 program on the same
      rows under the masked CE (positions 0..T-2), by the model-parallel
      phase's method: the reference runs over the arm's partition (its
      microbatches or data replicas, and its seq shards as position
      chunks, each embedded through its own bf16 copy of the table), and
      the limit a leaf is ``MP["spread_factor"]`` x that reference's own
      flash-vs-materialised spread (at least 2**-8), the loss's at least
      ``BF16_PARITY_RTOL[0]``. The arms: sp alone (seq 4 ring and
      ulysses, seq 2 x data 2 ring), pp x sp at 4 microbatches of 4 rows
      (stage 4 x seq 2 gpipe-ring, 1f1b-ring, 1f1b-ulysses, zb-ulysses;
      interleaved 2 x 3 x seq 2 ring; zb-v 3 x seq 2 ulysses) and pp x tp
      x sp (stage 4 x model 2 x seq 2 1f1b, ring and ulysses); each
      prints its tok_embed gradient's distance from the float32 program's
      beside its reference's. Each arm's
      flash launches: Ulysses 2 forwards and 1 backward a (block,
      microbatch, seq slot, model slot) under remat (zb: 3 and 2, chunk
      0's blocks 2 and 1), the ring none, no other kernel and no SDPA
      call. The worst leaf and its share are printed;
    * the ring's two rotate modes on the seq 4 arm: loss and gradients
      bit-equal;
    * ``SP["steps"]`` steps of sp seq 4 ulysses and ring, pp x sp 1f1b
      ring (4 x 2) and pp x tp x sp 1f1b ulysses (4 x 2 x 2), eager (CUDA
      events a step) and graphed through ``train_lm``: losses finite and
      falling, graphed losses and trained params bit-equal to eager,
      launches a step, step p50, peak memory and tokens/s beside the
      graphed single program's. Every check is fatal."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences
    from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
    from tpu_dist_nn_torch.models.transformer import (
        dot_product_attention,
        init_transformer,
        maybe_remat,
        param_leaves,
        tree_map,
        unembed,
        unstack_blocks,
    )
    from tpu_dist_nn_torch.parallel import ring_attention as ra
    from tpu_dist_nn_torch.parallel.ring_attention import embed_at
    from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.train.lm_trainer import (
        LMTrainConfig,
        lm_block_layout,
        make_pipeline_sp_lm_train_step,
        make_seq_parallel_lm_train_step,
        train_lm,
    )
    from tpu_dist_nn_torch.train.optimizers import build_optimizer

    t_phase = time.monotonic()
    T, B, M, L = cfg.max_seq_len, LM["batch"], SP["micro"], cfg.n_layers
    rows = lm_sequences(encode(text), T - 1)
    train_rows = rows[:max(1, int(len(rows) * 0.95))]
    params = init_transformer(torch.Generator().manual_seed(SP["seed"]), cfg, device=dev)
    stream = lm_batches(train_rows, B, seed=SP["seed"], epochs=None)
    batches = [torch.as_tensor(next(stream), device=dev).long() for _ in range(SP["steps"])]
    tokens = batches[0]
    names = [n for n, _ in _named_leaves(params)]

    def mesh(stage=1, model=1, seq=1, data=1):
        spec = MeshSpec(stage=stage, model=model, seq=seq, data=data)
        return build_mesh(spec, [dev] * spec.num_devices)

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

    def no_sdpa(*a, **kw):
        raise RuntimeError("scaled_dot_product_attention called on the sequence-parallel path")

    sdpa = F.scaled_dot_product_attention
    F.scaled_dot_product_attention = no_sdpa

    # (a) the references: the single program's masked CE on the same rows
    # over the arm's partition (row groups: its microbatches or data
    # replicas; position chunks: its seq shards), with the flash pair and
    # with the materialised attention (its own bf16 spread). Each
    # (row group, position chunk) embeds through its own bf16 copy of the
    # table, as each seq slot does: the embedding's backward sums a
    # token's rows in bf16, so the tied tok_embed gradient depends on how
    # the positions are split (on an H100 with this phase's rows: 21% of
    # its embedding part, 13% of the whole, from float32 for one copy of
    # the whole batch; 10% and 6.6% for four), far past the spread.
    tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones((B, T - 1), device=dev), torch.zeros((B, 1), device=dev)],
                     dim=1) / (B * (T - 1))

    def masked_step(c, attn, rows_, chunks):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        loss = 0.0
        for mb, tg, mk in zip(tokens.chunk(rows_), tgt.chunk(rows_), mask.chunk(rows_)):
            pc = c.cast_params(p)
            Tq = T // chunks
            x = torch.cat([embed_at(c.cast_params({k: p[k] for k in ("tok_embed", "pos_embed")}),
                                    t, q * Tq) for q, t in enumerate(mb.chunk(chunks, dim=1))],
                          dim=1)
            apply = maybe_remat(c)
            for block in unstack_blocks(pc["blocks"]):
                x = apply(block, x, c, attn)
            logp = torch.log_softmax(unembed(pc, x).float(), dim=-1)
            part = -(logp.gather(-1, tg[..., None])[..., 0] * mk).sum()
            part.backward()
            loss += float(part.detach())
        return loss, [a.grad for a in param_leaves(p)]

    g32 = masked_step(dataclasses.replace(cfg, compute_dtype="float32"), flash_attention, 1, 1)[1]
    i_tok = names.index("tok_embed")
    refs = {}
    for rows_, chunks in ((1, SP["seq"]), (2, 2), (M, SP["pp_seq"])):
        flash_ref = masked_step(cfg, flash_attention, rows_, chunks)
        dot_ref = masked_step(cfg, dot_product_attention, rows_, chunks)
        spread_loss = abs(dot_ref[0] - flash_ref[0]) / abs(flash_ref[0])
        spread = {n: rel(a, b) for n, a, b in zip(names, dot_ref[1], flash_ref[1])}
        refs[rows_, chunks] = (flash_ref,
                               max(MP["spread_factor"] * spread_loss, BF16_PARITY_RTOL[0]),
                               {n: max(MP["spread_factor"] * e, 2.0**-8)
                                for n, e in spread.items()}, dot_ref)
        print(f"seq parallel: 85M bf16 remat on {smi_line}; reference step 1 (single program, "
              f"masked CE, {rows_} row group(s) x {chunks} position chunks of {B // rows_} x "
              f"{T // chunks} tokens): loss {flash_ref[0]!r} (materialised {dot_ref[0]!r}: rel "
              f"{spread_loss:.3e}); spread a leaf "
              f"{json.dumps({n: float(f'{e:.3e}') for n, e in spread.items()})}; tok_embed "
              f"from float32 {rel(flash_ref[1][i_tok], g32[i_tok]):.3e}")
    torch.cuda.empty_cache()

    # (label, stage, virtual, model, seq, data, mode, schedule)
    ARMS = [("sp seq 4 ring", 1, 1, 1, SP["seq"], 1, "ring", None),
            ("sp seq 4 ulysses", 1, 1, 1, SP["seq"], 1, "ulysses", None),
            ("sp seq 2 x data 2 ring", 1, 1, 1, 2, 2, "ring", None)]
    S, Q, N = SP["stages"], SP["pp_seq"], SP["model"]
    for sched, mode in (("gpipe", "ring"), ("1f1b", "ring"), ("1f1b", "ulysses"),
                        ("zb", "ulysses")):
        ARMS.append((f"pp x sp {sched}-{mode} stage {S} x seq {Q}", S, 1, 1, Q, 1, mode, sched))
    ARMS.append((f"pp x sp interleaved-ring stage {SP['il_stages']} x virtual "
                 f"{SP['il_virtual']} x seq {Q}", SP["il_stages"], SP["il_virtual"], 1, Q, 1,
                 "ring", "interleaved"))
    ARMS.append((f"pp x sp zb-v-ulysses stage {SP['zbv_stages']} x seq {Q}", SP["zbv_stages"],
                 2, 1, Q, 1, "ulysses", "zb-v"))
    for mode in ("ring", "ulysses"):
        ARMS.append((f"pp x tp x sp 1f1b-{mode} stage {S} x model {N} x seq {Q}", S, 1, N, Q, 1,
                     mode, "1f1b"))

    def want_launches(stage, v, model, seq, data, mode, sched):
        if mode == "ring":
            return 0, 0
        if sched is None:  # one pass a data replica
            return 2 * L * data * seq, L * data * seq
        per = M * seq * model
        if sched in ("zb", "zb-v"):
            first = L // (stage * v)  # chunk 0's blocks
            return (3 * L - first) * per, (2 * L - first) * per
        return 2 * L * per, L * per

    def only_flash(launched, want):
        return ({k: n for k, n in launched.items() if n}
                == {k: n for k, n in zip(("flash_fwd_sm90", "flash_bwd_sm90"), want) if n})

    def first_step(stage, v, model, seq, data, mode, sched):
        m = mesh(stage, model, seq, data)
        if sched is None:
            p = tree_map(lambda a: a.clone().requires_grad_(True), params)
            loss = ra.make_seq_parallel_lm_loss(m, cfg, mode)(p, tokens)
            loss.backward()
            return float(loss.detach()), [a.grad for a in param_leaves(p)]
        shard, unshard = lm_block_layout(sched, stage, v, cfg=cfg, tp=model)
        T_ = "_tp" if model > 1 else ""
        if sched == "zb-v":
            vag = getattr(tpl, f"make_pipeline{T_}_sp_lm_zb_v_grad")(m, cfg, M, mode)
        elif sched in ("interleaved", "zb"):
            vag = getattr(tpl, f"make_pipeline{T_}_sp_lm_{sched}_grad")(m, cfg, v, M, mode)
        else:
            vag = getattr(tpl, f"make_pipeline{T_}_sp_lm_{sched}_grad")(m, cfg, stage, M, mode)
        loss, grads = vag(dict(params, blocks=shard(params["blocks"])), tokens)
        return float(loss), param_leaves(dict(grads, blocks=unshard(grads["blocks"])))

    worst_share = 0.0
    for label, stage, v, model, seq, data, mode, sched in ARMS:
        (loss_ref, g_ref), tol_loss, tol_g, (loss_dot, g_dot) = refs[
            (data, seq) if sched is None else (M, seq)]
        torch.cuda.synchronize()
        reset_launch_counts()
        loss, flat = first_step(stage, v, model, seq, data, mode, sched)
        torch.cuda.synchronize()
        launched = counts()
        errs = {n: rel(a, b) for n, a, b in zip(names, flat, g_ref)}
        share = {n: errs[n] / tol_g[n] for n in names}
        worst = max(share, key=share.get)
        worst_share = max(worst_share, share[worst])
        lrel = abs(loss - loss_ref) / abs(loss_ref)
        want = want_launches(stage, v, model, seq, data, mode, sched)
        ok = lrel <= tol_loss and share[worst] <= 1.0 and only_flash(launched, want)
        print(f"check seq parallel {label}, step 1 vs the reference: loss {loss!r} (rel "
              f"{lrel:.3e}, tol {tol_loss:.3e}); gradients' relative L2 "
              f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})}; largest share of "
              f"its tolerance {share[worst]:.3f} ({worst}: {errs[worst]:.3e} of {tol_g[worst]:.3e})"
              f"; tok_embed from float32 {rel(flat[i_tok], g32[i_tok]):.3e} (the reference's "
              f"{rel(g_ref[i_tok], g32[i_tok]):.3e}); from the materialised reference: loss "
              f"rel {abs(loss - loss_dot) / abs(loss_dot):.3e}, leaves' median relative L2 "
              f"{float(np.median([rel(a, b) for a, b in zip(flat, g_dot)])):.3e} (the flash "
              f"reference's {float(np.median([rel(a, b) for a, b in zip(g_ref, g_dot)])):.3e})"
              f"; launches "
              f"{json.dumps({k: n for k, n in launched.items() if n})}, expected "
              f"flash_fwd_sm90 {want[0]} flash_bwd_sm90 {want[1]} and nothing else | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"seq parallel {label}: the first step departs from the single program or "
                 f"launched other attention")
        del flat
        torch.cuda.empty_cache()
    print(f"seq parallel step 1: largest share of a limit over {len(ARMS)} arms {worst_share:.3f}")
    del refs, g32
    torch.cuda.empty_cache()

    # (b) both rotate modes on the seq 4 ring arm: the same bits
    ring = ra.ring_attention
    got = {}
    for r in ra.ROTATE_MODES:
        ra.ring_attention = lambda *a, rotate=None, _r=r, **kw: ring(*a, rotate=_r, **kw)
        try:
            got[r] = first_step(1, 1, 1, SP["seq"], 1, "ring", None)
        finally:
            ra.ring_attention = ring
    same = got["ppermute"][0] == got["collective"][0] and all(
        torch.equal(a, b) for a, b in zip(got["ppermute"][1], got["collective"][1]))
    print(f"check seq parallel rotate modes {ra.ROTATE_MODES} on sp seq {SP['seq']} ring, step "
          f"1: loss and every gradient bit-equal {same} | {'ok' if same else 'FAIL'}")
    if not same:
        fail("seq parallel: the two rotate modes give different bits")
    del got
    torch.cuda.empty_cache()

    # (c) steps eager (CUDA events) and graphed (train_lm), bit-equal
    host_batches = [b.cpu().numpy() for b in batches]
    n_steps = len(host_batches)
    train_cfg = LMTrainConfig(learning_rate=SP["lr"], steps=n_steps, batch_size=B, seq_len=T - 1,
                              log_every=1)

    def graphed_run(label, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trained, hist = train_lm(params, cfg, host_batches, train_cfg, **kw)
        torch.cuda.synchronize()
        launched, peak = counts(), torch.cuda.max_memory_allocated() / 1e9
        ms = [1e3 * (b["seconds"] - a["seconds"]) for a, b in zip(hist, hist[1:])]
        p50 = float(np.median(ms))
        print(f"seq parallel {label} graphed (train_lm): losses {[h['loss'] for h in hist]}; "
              f"step ms (host clock) {[round(t, 3) for t in ms]} after the first (warm-up and "
              f"capture, {1e3 * hist[0]['seconds']:.1f} ms); p50 {p50:.3f} ms, "
              f"{B * T / p50 * 1e3:.1f} tokens/s; peak memory {peak:.3f} GB")
        gc.collect()
        torch.cuda.empty_cache()
        return trained, [h["loss"] for h in hist], p50, launched, peak

    _, _, single_p50, _, single_peak = graphed_run("single program")
    STEP_ARMS = [("sp seq 4 ulysses", 1, 1, SP["seq"], "ulysses", "gpipe"),
                 ("sp seq 4 ring", 1, 1, SP["seq"], "ring", "gpipe"),
                 (f"pp x sp 1f1b-ring stage {S} x seq {Q}", S, 1, Q, "ring", "1f1b"),
                 (f"pp x tp x sp 1f1b-ulysses stage {S} x model {N} x seq {Q}", S, N, Q,
                  "ulysses", "1f1b")]
    summary = {}
    for label, stage, model, seq, mode, sched in STEP_ARMS:
        opt = build_optimizer(SP["lr"], total_steps=n_steps)
        if stage > 1:
            shard, unshard = lm_block_layout(sched, stage, 1, cfg=cfg, tp=model)
            st = tree_map(lambda a: a.detach().clone(),
                          dict(params, blocks=shard(params["blocks"])))
            step = make_pipeline_sp_lm_train_step(mesh(stage, model, seq), cfg, stage, M, opt,
                                                  mode, schedule=sched, tensor_parallel=model)
        else:
            unshard = None
            st = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
            step = make_seq_parallel_lm_train_step(mesh(seq=seq), cfg, opt, mode)
        state = opt.init(param_leaves(st))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, per_step = [], [], None
        for i, toks in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                reset_launch_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = step(st, state, toks)[2]
            e1.record()
            torch.cuda.synchronize()
            if i == 1:
                per_step = counts()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 1e9
        p50 = float(np.median(ms[1:]))
        eager = param_leaves(st if unshard is None else dict(st, blocks=unshard(st["blocks"])))
        del st, step, state
        torch.cuda.empty_cache()
        want = want_launches(stage, 1, model, seq, 1, mode, None if stage == 1 else sched)
        ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
              and only_flash(per_step, want))
        print(f"check seq parallel {label} eager: losses {losses}; step ms "
              f"{[round(t, 3) for t in ms]} (the first includes warm-up); p50 of steps "
              f"2-{len(ms)} {p50:.3f} ms, {B * T / p50 * 1e3:.1f} tokens/s; peak memory "
              f"{peak:.3f} GB; one step's launches "
              f"{json.dumps({k: n for k, n in per_step.items() if n})} (expected flash_fwd_sm90 "
              f"{want[0]}, flash_bwd_sm90 {want[1]}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"seq parallel {label}: losses not finite and falling, or other launches")
        kw = dict(mesh=mesh(stage, model, seq), num_stages=stage, num_microbatches=M,
                  schedule=sched, tensor_parallel=model, sp_mode=mode)
        trained, g_losses, g_p50, g_launched, g_peak = graphed_run(label, **kw)
        differ = sum(int((a != b).sum()) for a, b in zip(param_leaves(trained), eager))
        total = (want[0] * n_steps, want[1] * n_steps)
        ok = g_losses == losses and differ == 0 and only_flash(g_launched, total)
        print(f"check seq parallel {label} graphed vs eager over {n_steps} steps: losses "
              f"bit-equal {g_losses == losses}; trained parameter elements not bit-equal "
              f"{differ}; launches {json.dumps({k: n for k, n in g_launched.items() if n})} "
              f"(expected {total[0]} + {total[1]}); step p50 graphed {g_p50:.3f} ms, eager "
              f"{p50:.3f} ms ({p50 / g_p50:.2f}x), the graphed single program "
              f"{single_p50:.3f} ms ({g_p50 / single_p50:.2f}x it); peak memory graphed "
              f"{g_peak:.3f} GB, eager {peak:.3f}, the graphed single program "
              f"{single_peak:.3f} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"seq parallel {label}: the graphed step departs from the eager one")
        summary[label] = dict(eager_ms=round(p50, 3), graphed_ms=round(g_p50, 3),
                              tokens_per_s=round(B * T / g_p50 * 1e3, 1),
                              peak_gb_eager=round(peak, 3), peak_gb_graphed=round(g_peak, 3),
                              flash_launches_a_step=list(want))
        del trained, eager
        torch.cuda.empty_cache()
    F.scaled_dot_product_attention = sdpa
    print("seq parallel steps (graphed single program "
          f"{single_p50:.3f} ms, {single_peak:.3f} GB): " + json.dumps(summary))
    del params
    torch.cuda.empty_cache()
    print(f"seq parallel phase: {time.monotonic() - t_phase:.1f} s")


MOE = dict(experts=8, top_k=2, capacity=1.25, micro=4, steps=4, timed=1, lr=5e-5, seed=17,
           stages=4, il_stages=2, il_virtual=3, zbv_stages=3, near_tie=0.02)


def route_check(ref, arm, k: int, bound: float, row_len: int, seq_groups: int) -> dict:
    """Step-1 routes of an arm (``arm``, a :class:`RouteLog`) against the
    reference's over the same routing groups, layer by layer. A token
    whose expert choices differ is accepted only at a near tie of the
    reference (its smallest gap between adjacent probabilities among the
    top k + 1 under ``bound``). From the next layer on, that token and
    the later positions of its row (which attend to it) are left out: a
    flipped route or a dropped slot moves the token's output a lot. A
    token whose choices
    agree but whose slot was kept in one run and dropped in the other is
    accepted only in a group whose routes already differ (a flip shifts
    the capacity positions after it). A group holds rows of ``row_len``
    positions, the ``seq_groups`` position blocks of a row in
    consecutive groups. Returns the counts; ``rejected`` must be 0."""
    import torch

    got, want = arm.layers(), ref.layers()
    out = dict(layers=len(want), accepted=0, kept_shifts=0, rejected=0, tainted=0,
               max_accepted_gap=0.0)
    if sorted(got) != sorted(want):
        out["rejected"] = -1
        return out
    tainted = row = pos = None
    for layer in sorted(want):
        rt, rk, rp = want[layer]
        at, ak, _ = (t.to(rt.device) for t in got[layer])
        if at.shape != rt.shape:
            out["rejected"] = -1
            return out
        if tainted is None:
            G, S = rt.shape[:2]
            g = torch.arange(G, device=rt.device)[:, None]
            t = torch.arange(S, device=rt.device)[None, :]
            row = (g // seq_groups) * (S // row_len) + t // row_len
            pos = (g % seq_groups) * row_len + t % row_len
            tainted = torch.zeros((G, S), dtype=torch.bool, device=rt.device)
        top = rp.topk(min(k + 1, rp.shape[-1]), dim=-1).values
        gap = (top[..., :-1] - top[..., 1:]).min(dim=-1).values
        differ = (rt != at).any(dim=-1)
        flip = differ & ~tainted
        near = flip & (gap < bound)
        kept = (rk != ak).any(dim=-1) & ~differ & ~tainted
        moved = (differ | tainted).any(dim=-1, keepdim=True)
        out["accepted"] += int(near.sum())
        out["rejected"] += int((flip & ~near).sum()) + int((kept & ~moved).sum())
        out["kept_shifts"] += int((kept & moved).sum())
        if bool(near.any()):
            out["max_accepted_gap"] = max(out["max_accepted_gap"], float(gap[near].max()))
        out["tainted"] += int(tainted.sum())
        changed = differ | (rk != ak).any(dim=-1)  # a route or a dropped slot
        if bool(changed.any()):
            # each row's first changed position; later positions attend to it
            first = torch.full((int(row.max()) + 1,), pos.numel(), device=rt.device)
            first = first.scatter_reduce(0, row[changed], pos[changed], reduce="amin")
            tainted = tainted | (pos >= first[row])
    return out


def moe_phase(dev, cfg, text, out_dir, smi_line) -> None:
    """The mixture-of-experts LM at the 85M width (``cfg``'s: d 768, 12
    heads, 12 layers, bf16, remat) with README's ``--experts 8
    --router-top-k 2`` and capacity 1.25, seeded, batch 16 x 1,024
    tokens, on slots of one card (cut from a multi-chip mesh); 4
    microbatches of 4 rows where it pipelines. The arms: the single
    program; flat EP at expert 2 x data 2; TP inside the experts at
    expert 2 x model 2; sp x ep at seq 2 x expert 2, ring and Ulysses;
    pp x ep at stage 4 x expert 2 on gpipe, 1f1b and zb, interleaved at
    2 stages x 3 virtual x expert 2 and zb-v at 3 stages x expert 2; pp x
    sp x ep (Ulysses) on gpipe at stage 2 x seq 2 x expert 2.

    * step 1 of each arm against the grouped single bf16 program over the
      same routing groups (``n_groups = M x data x expert``,
      ``n_seq_groups = seq``), run over the arm's partition (each row
      group and position chunk embedded through its own bf16 copy of the
      table), at the model-parallel phase's limits: ``MP["spread_factor"]``
      x the reference's own flash-vs-materialised spread a leaf (at least
      2**-8; the loss at least ``BF16_PARITY_RTOL[0]``). Each layer's
      routes against the reference's (:func:`route_check`: a differing
      route accepted only at a near tie, under ``MOE["near_tie"]`` in
      probability; the accepted ones printed). The flash launches of the
      step equal the dense arm's of the same partition (2 forwards and 1
      backward a block and attention shard under remat; zb and zb-v 3
      and 2, chunk 0's blocks 2 and 1; the ring none), with SDPA replaced
      by a raise;
    * the check can fail: the flat EP arm with its shard 0 routing its
      tokens one position off (the wrong group) must be caught;
    * the single program, flat EP, sp x ep Ulysses and pp x ep 1f1b take
      ``MOE["steps"]`` steps eager (CUDA events) and graphed through
      ``train_lm``: losses finite and falling, graphed losses and trained
      params bit-equal to eager, launches a step; every other arm takes
      ``MOE["timed"]`` eager steps after step 1. Each arm's step p50,
      tokens/s and peak memory beside the single program's. Every check
      is fatal."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences
    from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
    from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
    from tpu_dist_nn_torch.models.transformer import (
        dot_product_attention,
        param_leaves,
        tree_map,
        unembed,
        unstack_blocks,
    )
    from tpu_dist_nn_torch.parallel import expert_parallel as ep
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.ring_attention import embed_at
    from tpu_dist_nn_torch.train.lm_trainer import (
        LMTrainConfig,
        lm_block_layout,
        make_ep_tp_moe_lm_train_step,
        make_moe_lm_train_step,
        make_pipeline_moe_lm_train_step,
        make_sp_moe_lm_train_step,
        train_lm,
    )
    from tpu_dist_nn_torch.train.optimizers import build_optimizer

    t_phase = time.monotonic()
    mcfg = ep.MoEConfig(**dataclasses.asdict(cfg), n_experts=MOE["experts"],
                        capacity_factor=MOE["capacity"], router_top_k=MOE["top_k"])
    T, B, M, L, K = mcfg.max_seq_len, LM["batch"], MOE["micro"], mcfg.n_layers, MOE["top_k"]
    ids = encode(text)
    shifted_rows = lm_sequences(ids, T)  # T + 1 tokens: inputs and targets
    full_rows = lm_sequences(ids, T - 1)  # T tokens: the sp arms' full rows

    def batches_of(rows):
        train = rows[:max(1, int(len(rows) * 0.95))]
        stream = lm_batches(train, B, seed=MOE["seed"], epochs=None)
        return [torch.as_tensor(next(stream), device=dev).long() for _ in range(MOE["steps"])]

    shifted, full = batches_of(shifted_rows), batches_of(full_rows)
    params = ep.init_moe_transformer(torch.Generator().manual_seed(MOE["seed"]), mcfg,
                                     device=dev)
    names = [n for n, _ in _named_leaves(params)]
    print(f"moe: {sum(int(a.numel()) for a in param_leaves(params)):,} parameters ({MOE['experts']} "
          f"experts, top-{K}, capacity {MOE['capacity']}: {mcfg.capacity(B * T)} slots an expert "
          f"for a group of {B * T} tokens) on {smi_line}")

    def mesh(stage=1, model=1, seq=1, data=1, expert=1):
        spec = MeshSpec(stage=stage, model=model, seq=seq, data=data, expert=expert)
        return build_mesh(spec, [dev] * spec.num_devices)

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

    def no_sdpa(*a, **kw):
        raise RuntimeError("scaled_dot_product_attention called on the MoE path")

    sdpa = F.scaled_dot_product_attention
    F.scaled_dot_product_attention = no_sdpa

    # (a) the references: the grouped single program over the arm's
    # partition, R row groups x Q position chunks (a routing group each),
    # with the flash pair and with the materialised attention.
    def reference(attn, R, Q, log=None):
        toks = full[0] if Q > 1 else shifted[0]
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        loss = 0.0
        with ep.recording_routes(log) if log is not None else contextlib.nullcontext():
            for rows in toks.chunk(R):
                pc = mcfg.cast_params(p)
                inp = rows if Q > 1 else rows[:, :-1]
                Tq = inp.shape[1] // Q
                # Each (row group, position chunk) embeds through its own
                # bf16 copy of the table, as each shard does; the single
                # program embeds and unembeds through one.
                x = torch.cat([embed_at(pc if R * Q == 1 else mcfg.cast_params(
                    {k: p[k] for k in ("tok_embed", "pos_embed")}), t, q * Tq)
                    for q, t in enumerate(inp.chunk(Q, dim=1))], dim=1)
                apply = ep._maybe_remat(mcfg, ep.moe_block_apply)
                auxs = []
                for layer, block in enumerate(unstack_blocks(pc["blocks"])):
                    ep._at_layer(layer)
                    x, aux = apply(block, x, mcfg, 1, attn,
                                   lambda b, h: ep.moe_ffn_apply(b, h, mcfg, 1, Q))
                    auxs.append(aux)
                logp = torch.log_softmax(unembed(pc, x).float(), dim=-1)
                if Q > 1:
                    ll = logp[:, :-1].gather(-1, rows[:, 1:, None])[..., 0]
                    part = -ll.sum() / (B * (T - 1))
                else:
                    ll = logp.gather(-1, rows[:, 1:, None])[..., 0]
                    part = -ll.mean() / R
                part = part + mcfg.router_aux_weight * torch.stack(auxs).mean() / R
                part.backward()
                loss += float(part.detach())
        return loss, [a.grad for a in param_leaves(p)]

    refs = {}
    for R, Q in ((1, 1), (4, 1), (2, 1), (2, 2), (2 * M, 1), (2 * M, 2)):
        log = ep.RouteLog()
        flash_ref = reference(flash_attention, R, Q, log)
        dot_ref = reference(dot_product_attention, R, Q)
        spread_loss = abs(dot_ref[0] - flash_ref[0]) / abs(flash_ref[0])
        spread = {n: rel(a, b) for n, a, b in zip(names, dot_ref[1], flash_ref[1])}
        refs[R, Q] = (flash_ref, max(MP["spread_factor"] * spread_loss, BF16_PARITY_RTOL[0]),
                      {n: max(MP["spread_factor"] * e, 2.0**-8) for n, e in spread.items()}, log)
        print(f"moe: reference step 1 (grouped single program, {R} row group(s) x {Q} position "
              f"chunk(s), {R * Q} routing groups of {B * T // (R * Q)} tokens): loss "
              f"{flash_ref[0]!r} (materialised {dot_ref[0]!r}: rel {spread_loss:.3e}); spread a "
              f"leaf {json.dumps({n: float(f'{e:.3e}') for n, e in spread.items()})}")
        del dot_ref
    torch.cuda.empty_cache()

    # (label, kind, dict(stage, virtual, model, seq, data, expert, mode, sched), (R, Q))
    S, Sil, vil, Sv = MOE["stages"], MOE["il_stages"], MOE["il_virtual"], MOE["zbv_stages"]
    ARMS = [("single", "single", {}, (1, 1)),
            ("flat EP expert 2 x data 2", "ep", dict(data=2, expert=2), (4, 1)),
            ("TP inside experts expert 2 x model 2", "tp", dict(expert=2, model=2), (2, 1)),
            ("sp x ep ring seq 2 x expert 2", "sp", dict(seq=2, expert=2, mode="ring"), (2, 2)),
            ("sp x ep ulysses seq 2 x expert 2", "sp", dict(seq=2, expert=2, mode="ulysses"),
             (2, 2))]
    for sched in ("gpipe", "1f1b", "zb"):
        ARMS.append((f"pp x ep {sched} stage {S} x expert 2", "pp",
                     dict(stage=S, expert=2, sched=sched, virtual=1), (2 * M, 1)))
    ARMS.append((f"pp x ep interleaved stage {Sil} x virtual {vil} x expert 2", "pp",
                 dict(stage=Sil, expert=2, sched="interleaved", virtual=vil), (2 * M, 1)))
    ARMS.append((f"pp x ep zb-v stage {Sv} x expert 2", "pp",
                 dict(stage=Sv, expert=2, sched="zb-v", virtual=2), (2 * M, 1)))
    ARMS.append(("pp x sp x ep gpipe-ulysses stage 2 x seq 2 x expert 2", "ppsp",
                 dict(stage=2, seq=2, expert=2, mode="ulysses", sched="gpipe", virtual=1),
                 (2 * M, 2)))

    def want_launches(kind, a):
        """The dense arm's flash launches for the same partition: 2
        forwards and 1 backward a block and attention shard under remat."""
        X, Q = a.get("expert", 1), a.get("seq", 1)
        if a.get("mode") == "ring":
            return 0, 0
        shards = {"single": 1, "ep": a.get("data", 1) * X, "tp": X, "sp": X * Q}.get(kind)
        if shards is not None:
            return 2 * L * shards, L * shards
        per = M * X * Q
        if a["sched"] in ("zb", "zb-v"):
            first = L // (a["stage"] * a["virtual"])
            return (3 * L - first) * per, (2 * L - first) * per
        return 2 * L * per, L * per

    def only_flash(launched, want):
        return ({k: n for k, n in launched.items() if n}
                == {k: n for k, n in zip(("flash_fwd_sm90", "flash_bwd_sm90"), want) if n})

    def first_step(kind, a):
        X = a.get("expert", 1)
        if kind == "single":
            p = tree_map(lambda t: t.clone().requires_grad_(True), params)
            loss = ep.moe_lm_loss(p, shifted[0], mcfg, attn_fn=flash_attention)
            loss.backward()
            return float(loss.detach()), [t.grad for t in param_leaves(p)]
        if kind in ("ep", "tp", "sp"):
            m = mesh(model=a.get("model", 1), seq=a.get("seq", 1), data=a.get("data", 1),
                     expert=X)
            fn = {"ep": lambda: ep.make_ep_lm_forward(m, mcfg, with_loss=True),
                  "tp": lambda: ep.make_ep_tp_lm_loss(m, mcfg),
                  "sp": lambda: ep.make_sp_ep_lm_loss(m, mcfg, a.get("mode"))}[kind]()
            p = tree_map(lambda t: t.clone().requires_grad_(True),
                         dict(params, blocks=ep.ep_shard_blocks(params["blocks"], X)))
            loss = fn(p, full[0] if kind == "sp" else shifted[0])
            loss.backward()
            g = tree_map(lambda t: t.grad, p)
            return float(loss.detach()), param_leaves(dict(g, blocks=ep.ep_unshard_blocks(
                g["blocks"])))
        stage, v, sched = a["stage"], a["virtual"], a["sched"]
        shard, unshard = lm_block_layout(sched, stage, v, ep=X)
        if kind == "ppsp":
            vag = ep.make_pipeline_sp_ep_lm_gpipe_grad(mesh(stage=stage, seq=a["seq"], expert=X),
                                                       mcfg, stage, M, a["mode"])
        elif sched == "zb-v":
            vag = ep.make_pipeline_ep_lm_zb_v_grad(mesh(stage=stage, expert=X), mcfg, M)
        elif sched in ("interleaved", "zb"):
            vag = getattr(ep, f"make_pipeline_ep_lm_{sched}_grad")(
                mesh(stage=stage, expert=X), mcfg, v, M)
        else:
            vag = getattr(ep, f"make_pipeline_ep_lm_{sched}_grad")(
                mesh(stage=stage, expert=X), mcfg, stage, M)
        loss, grads = vag(dict(params, blocks=shard(params["blocks"])),
                          full[0] if kind == "ppsp" else shifted[0])
        return float(loss), param_leaves(dict(grads, blocks=unshard(grads["blocks"])))

    def check_step1(label, kind, a, RQ, log):
        (loss_ref, g_ref), tol_loss, tol_g, ref_log = refs[RQ]
        torch.cuda.synchronize()
        reset_launch_counts()
        with ep.recording_routes(log):
            loss, flat = first_step(kind, a)
        torch.cuda.synchronize()
        launched = counts()
        errs = {n: rel(x, y) for n, x, y in zip(names, flat, g_ref)}
        share = {n: errs[n] / tol_g[n] for n in names}
        worst = max(share, key=share.get)
        lrel = abs(loss - loss_ref) / abs(loss_ref)
        Q = RQ[1]
        routes = route_check(ref_log, log, K, MOE["near_tie"], T // Q, Q)
        return loss, lrel, tol_loss, errs, share, worst, launched, routes

    worst_share = 0.0
    for label, kind, a, RQ in ARMS:
        loss, lrel, tol_loss, errs, share, worst, launched, routes = check_step1(
            label, kind, a, RQ, ep.RouteLog())
        worst_share = max(worst_share, share[worst])
        want = want_launches(kind, a)
        ok = (lrel <= tol_loss and share[worst] <= 1.0 and routes["rejected"] == 0
              and only_flash(launched, want))
        print(f"check moe {label}, step 1 vs the grouped program ({RQ[0]} x {RQ[1]}): loss "
              f"{loss!r} (rel {lrel:.3e}, tol {tol_loss:.3e}); gradients' relative L2 "
              f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})}; largest share of "
              f"its tolerance {share[worst]:.3f} ({worst}); routes over {routes['layers']} "
              f"layers: {routes['accepted']} differing at a near tie (largest gap "
              f"{routes['max_accepted_gap']:.3e}, bound {MOE['near_tie']}), {routes['kept_shifts']}"
              f" capacity shifts after them, {routes['tainted']} token-layers after a flip not "
              f"compared, {routes['rejected']} rejected; launches "
              f"{json.dumps({k: n for k, n in launched.items() if n})}, the dense partition's "
              f"flash_fwd_sm90 {want[0]} flash_bwd_sm90 {want[1]} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"moe {label}: the first step departs from the grouped single program, routes "
                 f"away from a near tie, or launched other attention")
        torch.cuda.empty_cache()
    print(f"moe step 1: largest share of a limit over {len(ARMS)} arms {worst_share:.3f}")

    # (b) the check can fail: shard 0 of each flat EP replica routes its
    # tokens one position off.
    route_shards = ep._route_shards

    def wrong_group(blocks, hs, c, slots):
        return route_shards(blocks, [hs[0].roll(1, dims=1)] + list(hs[1:]), c, slots)

    ep._route_shards = wrong_group
    try:
        loss, lrel, tol_loss, errs, share, worst, _, routes = check_step1(
            "fault", "ep", dict(data=2, expert=2), (4, 1), ep.RouteLog())
    finally:
        ep._route_shards = route_shards
    caught = routes["rejected"] != 0 and (lrel > tol_loss or share[worst] > 1.0)
    print(f"check moe the route check can fail: flat EP with shard 0 routing one position off: "
          f"{routes['rejected']} routes rejected, loss rel {lrel:.3e} (tol {tol_loss:.3e}), "
          f"largest share {share[worst]:.3f} ({worst}) | {'ok' if caught else 'FAIL'}")
    if not caught:
        fail("moe: a shard routing the wrong group passed the step-1 check")
    del refs
    torch.cuda.empty_cache()

    # (c) steps: eager (CUDA events) for every arm; graphed through
    # train_lm, bit-equal to eager, for four of them.
    train_cfg = LMTrainConfig(learning_rate=MOE["lr"], steps=MOE["steps"], batch_size=B,
                              seq_len=T, log_every=1)

    def make_step(kind, a, opt):
        """The train step ``train_lm`` builds for the arm, its staged
        params and the inverse layout."""
        X = a.get("expert", 1)
        if kind == "single":
            st = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
            return make_moe_lm_train_step(mcfg, opt), st, None
        if kind in ("ep", "tp", "sp"):
            m = mesh(model=a.get("model", 1), seq=a.get("seq", 1), data=a.get("data", 1),
                     expert=X)
            st = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          dict(params, blocks=ep.ep_shard_blocks(params["blocks"], X)))
            step = {"ep": lambda: make_moe_lm_train_step(mcfg, opt, m),
                    "tp": lambda: make_ep_tp_moe_lm_train_step(m, mcfg, opt),
                    "sp": lambda: make_sp_moe_lm_train_step(m, mcfg, opt, a["mode"])}[kind]()
            return step, st, ep.ep_unshard_blocks
        shard, unshard = lm_block_layout(a["sched"], a["stage"], a["virtual"], ep=X)
        st = tree_map(lambda t: t.detach().clone(), dict(params, blocks=shard(params["blocks"])))
        m = mesh(stage=a["stage"], seq=a.get("seq", 1), expert=X)
        step = make_pipeline_moe_lm_train_step(m, mcfg, a["stage"], M, opt, schedule=a["sched"],
                                               num_virtual=a["virtual"],
                                               sp_mode=a.get("mode") if kind == "ppsp" else None)
        return step, st, unshard

    def eager_run(kind, a, n):
        opt = build_optimizer(MOE["lr"], total_steps=MOE["steps"])
        step, st, unshard = make_step(kind, a, opt)
        state = opt.init(param_leaves(st))
        toks = full if kind in ("sp", "ppsp") else shifted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, per_step = [], [], None
        for i in range(n):
            if i == 1:
                torch.cuda.synchronize()
                reset_launch_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = step(st, state, toks[i])[2]
            e1.record()
            torch.cuda.synchronize()
            if i == 1:
                per_step = counts()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 1e9
        trained = param_leaves(st if unshard is None else dict(st, blocks=unshard(st["blocks"])))
        del step, state
        return losses, ms, per_step, peak, trained

    def graphed_run(kind, a):
        kw = {}
        X = a.get("expert", 1)
        if kind != "single":
            kw = dict(mesh=mesh(stage=a.get("stage", 1), model=a.get("model", 1),
                                seq=a.get("seq", 1), data=a.get("data", 1), expert=X),
                      num_stages=a.get("stage", 1), num_microbatches=M,
                      schedule=a.get("sched", "gpipe"), num_virtual=a.get("virtual", 1),
                      sp_mode=a.get("mode") or "ring")
        toks = full if kind in ("sp", "ppsp") else shifted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trained, hist = train_lm(params, mcfg, [t.cpu().numpy() for t in toks], train_cfg, **kw)
        torch.cuda.synchronize()
        launched, peak = counts(), torch.cuda.max_memory_allocated() / 1e9
        ms = [1e3 * (b["seconds"] - a_["seconds"]) for a_, b in zip(hist, hist[1:])]
        return param_leaves(trained), [h["loss"] for h in hist], float(np.median(ms)), launched, \
            peak, ms

    GRAPHED = {"single", "flat EP expert 2 x data 2", "sp x ep ulysses seq 2 x expert 2",
               f"pp x ep 1f1b stage {S} x expert 2"}
    summary, single = {}, None
    for label, kind, a, _ in ARMS:
        n = MOE["steps"] if label in GRAPHED else 1 + MOE["timed"]
        losses, ms, per_step, peak, eager = eager_run(kind, a, n)
        p50 = float(np.median(ms[1:]))
        want = want_launches(kind, a)
        ok = (all(math.isfinite(x) for x in losses) and only_flash(per_step, want)
              and (n < 3 or losses[-1] < losses[0]))
        line = dict(eager_ms=round(p50, 3), tokens_per_s=round(B * T / p50 * 1e3, 1),
                    peak_gb=round(peak, 3), flash_launches_a_step=list(want))
        if label in GRAPHED:
            trained, g_losses, g_p50, g_launched, g_peak, g_ms = graphed_run(kind, a)
            differ = sum(int((x != y).sum()) for x, y in zip(trained, eager))
            total = (want[0] * n, want[1] * n)
            ok = ok and g_losses == losses and differ == 0 and only_flash(g_launched, total)
            line.update(graphed_ms=round(g_p50, 3), tokens_per_s=round(B * T / g_p50 * 1e3, 1),
                        peak_gb_graphed=round(g_peak, 3))
            print(f"moe {label} graphed (train_lm): losses {g_losses}; step ms (host clock) "
                  f"{[round(t, 3) for t in g_ms]}; losses bit-equal to eager "
                  f"{g_losses == losses}, trained elements not bit-equal {differ}; launches "
                  f"{json.dumps({k: v for k, v in g_launched.items() if v})} (expected "
                  f"{total[0]} + {total[1]}); peak {g_peak:.3f} GB")
            del trained
        if single is None:
            single = line
        graphed = f", graphed {line['graphed_ms']:.3f} ms" if "graphed_ms" in line else ""
        print(f"check moe {label} steps: eager losses {losses}; step ms "
              f"{[round(t, 3) for t in ms]} (the first includes warm-up); p50 {p50:.3f} ms"
              f"{graphed}, {line['tokens_per_s']} tokens/s, peak {peak:.3f} GB (the single program: "
              f"{single.get('graphed_ms', single['eager_ms'])} ms, {single['peak_gb']} GB); one "
              f"step's launches {json.dumps({k: v for k, v in per_step.items() if v})} (the "
              f"dense partition's {want[0]} + {want[1]}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"moe {label}: losses not finite and falling, other launches, or the graphed "
                 f"step departs from the eager one")
        summary[label] = line
        del eager
        gc.collect()
        torch.cuda.empty_cache()
    F.scaled_dot_product_attention = sdpa
    print("moe steps: " + json.dumps(summary))
    del params
    torch.cuda.empty_cache()
    print(f"moe phase: {time.monotonic() - t_phase:.1f} s")


# Data parallelism and sharded optimizer state: 4 data slots of the card
# (cut from a multi-chip mesh). The LM arms use the model-parallel
# phase's constant lr and limits; `clip` is the fraction of the
# reference's global gradient norm that clip_norm is set to (so the clip
# binds, and a per-slice clip would show).
DP = dict(data=4, sp_data=2, sp_seq=2, steps=6, lr=5e-5, seed=19, clip=0.5, step_runs=100,
          digits_epochs=40)


def data_parallel_phase(dev, model, conv_model, data, data_c, cfg, text, train_rows, out_dir,
                        smi_line, compare) -> None:
    """Data parallelism on ``DP["data"]`` data slots of one card (cut from
    a multi-chip mesh), and ZeRO-1 / FSDP for the 85M LM (``cfg``: bf16,
    remat):

    * (a) the data-sharded engine (``Engine.up(model, data_parallel=4,
      devices=[card] * 4)``): the MNIST FCNN's 60,000 rows at batch 8,192
      in float32 (every row within 1e-5 of the float64 oracle's
      arithmetic batched, which is within 1e-10 of the per-row oracle on
      2,048 rows, and bit-equal to the single-program engine) and
      int8 (bit-equal to the single-program int8 engine, within the main
      path's tolerance of the plain ``forward_quantized``), one 8,191-row
      batch (a pad tail of 1), and the CIFAR conv+MLP's 10,000 rows at
      1,024 and one 1,023-row batch against the single-program engine
      (``CONV_TOL``). Each kernel's launches a batch, and the stream of
      every launch: each of the 4 slots launches each kernel once a batch
      on its own stream, or the phase fails. samples/s of the f32 engine
      beside the single program's, in turns;
    * (b) the FCNN through ``Engine.train`` on the 4 slots: step 1's
      summed gradients (what the optimizer receives) against the single
      program's at ``GRAD_TOL``; the step eager and graphed in turns
      (``timed_arms``: bit-equal) beside the single program's graphed
      step, ms/step; the digits recipe (64-128-64-10, 40 epochs, cosine
      after 50 warm-up steps) through the data-sharded engine, held-out
      accuracy at the digits bar;
    * (c) four LM arms, batch 16 x 1,024: ZeRO-1 and FSDP at data 4, sp x
      ZeRO-1 (Ulysses) and sp x FSDP (ring) at seq 2 x data 2, with
      ``clip_norm`` at ``DP["clip"]`` of the reference's global norm.
      Step 1 against the single bf16 program over the arm's partition
      (row groups; for sp, position chunks embedded through their own
      bf16 copy) by the model-parallel phase's method: the loss, and Adam's
      first moment after the step over ``1 - b1`` (the clipped gradient
      each slot received, gathered) against the reference's gradient
      clipped by its global norm, each leaf within ``MP["spread_factor"]``
      x the reference's flash-vs-materialised spread; a ZeRO-1 run whose
      optimizer clips each slice by its own norm must fail that check.
      Ownership: each slot's moment (FSDP: and param) elements exactly
      1/N of every sliced leaf's. The flash launches of the step the
      dense partition's (Ulysses and the plain step 2 forwards and 1
      backward a block and slot under remat, the ring none), SDPA
      replaced by a raise. ``DP["steps"]`` steps eager (CUDA events) and
      graphed through ``train_lm``: finite, falling losses, bit-equal
      losses and trained params, step p50, tokens/s and peak memory
      beside the graphed single program's. Every check is fatal."""
    from collections import Counter

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.data.datasets import real_digits, synthetic_mnist
    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences
    from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, forward_quantized, reset_launch_counts
    from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
    from tpu_dist_nn_torch.models import network
    from tpu_dist_nn_torch.models.fcnn import init_fcnn, params_from_spec, spec_from_params
    from tpu_dist_nn_torch.models.transformer import (
        dot_product_attention,
        init_transformer,
        lm_loss,
        maybe_remat,
        param_leaves,
        tree_map,
        unembed,
        unstack_blocks,
    )
    from tpu_dist_nn_torch.parallel import zero
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.ring_attention import embed_at
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, train_lm
    from tpu_dist_nn_torch.train.optimizers import B1, Optimizer, build_optimizer
    from tpu_dist_nn_torch.train.trainer import (
        TrainConfig,
        _leaves,
        _split_params,
        compile_train_step,
        make_train_step,
    )

    t_phase = time.monotonic()
    N = DP["data"]

    def mesh(data, seq=1):
        return build_mesh(MeshSpec(data=data, seq=seq), [dev] * (data * seq))

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    # ------------------------------------------- (a) the data-sharded engine
    # Each kernel wrapper as the network module calls it, wrapped to log
    # the stream it launches on.
    streams: list = []
    wrapped = {}
    for kname in ("fcnn_fused_forward", "fcnn_quantized_forward", "fused_conv2d"):
        orig = getattr(network, kname)
        wrapped[kname] = orig

        def logged(*a, _orig=orig, _name=kname, **kw):
            streams.append((_name, torch.cuda.current_stream().cuda_stream))
            return _orig(*a, **kw)

        setattr(network, kname, logged)

    def per_slot(eng, kname, n_batches, per_batch):
        """Every batch's launches of ``kname``: ``per_batch`` on each slot's stream."""
        slot_streams = [getattr(s.stream, "cuda_stream", None) for s in eng.mesh.slots[0]]
        got = [st for name, st in streams if name == kname]
        want = [st for _ in range(n_batches) for st in slot_streams for _ in range(per_batch)]
        return Counter(got) == Counter(want) and len(set(got)) == N

    try:
        single = Engine.up(model, device=dev)
        dp = Engine.up(model, data_parallel=N, devices=[dev] * N)
        place = dp.placement()
        if not (dp.data_sharded and place["data_parallel"] == N and not place["pipelined"]):
            fail(f"data parallel: the engine did not take the data-sharded placement: {place}")
        n_batches = math.ceil(ROWS / BATCH)
        streams.clear()
        reset_launch_counts()
        res = dp.run_inference(data, batch_size=BATCH)
        launched = counts()
        slots_ok = per_slot(dp, "fcnn_fused_forward", n_batches, 1)
        # Every row against the oracle's arithmetic batched in float64
        # (dense_f64), which is held to the per-row oracle on the first
        # 2,048 rows, and bit for bit against the single program.
        want = dense_f64(model, data)
        o_err = float(np.abs(res.outputs - want).max())
        sample = oracle_forward_batch(model, data[:2048])
        s_err = float(np.abs(res.outputs[:2048] - sample).max())
        ref_err = float(np.abs(want[:2048] - sample).max())
        differ = int((res.outputs != single.run_inference(data, batch_size=BATCH).outputs).sum())
        odd = dp.infer(data[:BATCH - 1])
        odd_err = float(np.abs(odd - want[:BATCH - 1]).max())
        odd_differ = int((odd != single.infer(data[:BATCH - 1])).sum())
        ok = (slots_ok and launched["fcnn_fused_forward"] == N * n_batches and o_err <= 1e-5
              and s_err <= 1e-5 and ref_err <= 1e-10 and differ == 0 and odd_err <= 1e-5
              and odd_differ == 0 and odd.shape == (BATCH - 1, MNIST[-1]))
        print(f"check data parallel f32 engine ({N} data slots of {smi_line}; placement "
              f"{json.dumps(place)}): {ROWS} rows at batch {BATCH}: launches "
              f"{json.dumps({k: n for k, n in launched.items() if n})} ({n_batches} batches: "
              f"{launched['fcnn_fused_forward'] / n_batches:g} chain launches a batch, each slot "
              f"once a batch on its own stream {slots_ok}); all {ROWS} rows vs the float64 "
              f"oracle's arithmetic batched max_abs {o_err:.3e} (the per-row oracle on 2048 rows: "
              f"{s_err:.3e}; batched vs per-row {ref_err:.3e}, tol 1e-10); not bit-equal to the "
              f"single-program engine {differ} of {res.outputs.size}; a batch of {BATCH - 1} rows "
              f"(pad 1) max_abs {odd_err:.3e}, not bit-equal {odd_differ} | tol atol 1e-05 | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("data parallel: the f32 engine's slots did not each launch once a batch, or "
                 "its outputs disagree with the oracle or the single program")
        singleq = Engine.up(model, device=dev, quantize="int8")
        dpq = Engine.up(model, data_parallel=N, devices=[dev] * N, quantize="int8")
        streams.clear()
        reset_launch_counts()
        resq = dpq.run_inference(data, batch_size=BATCH)
        launched = counts()
        slots_ok = per_slot(dpq, "fcnn_quantized_forward", n_batches, 1)
        want_q = singleq.run_inference(data, batch_size=BATCH).outputs
        differ = int((resq.outputs != want_q).sum())
        oddq = dpq.infer(data[:BATCH - 1])
        odd_differ = int((oddq != singleq.infer(data[:BATCH - 1])).sum())
        ok = (slots_ok and launched["fcnn_quantized_forward"] == N * n_batches and differ == 0
              and odd_differ == 0)
        print(f"check data parallel int8 engine: launches "
              f"{json.dumps({k: n for k, n in launched.items() if n})}, each slot once a batch "
              f"on its own stream {slots_ok}; not bit-equal to the single-program int8 engine "
              f"{differ} of {resq.outputs.size} (the {BATCH - 1}-row batch: {odd_differ}) | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("data parallel: the int8 engine differs from the single program or a slot "
                 "did not launch")
        compare("data parallel int8 engine vs plain forward_quantized (60000 rows)",
                torch.from_numpy(resq.outputs),
                forward_quantized(dpq._q, torch.from_numpy(data).to(dev)).cpu(), 1e-7, 1e-6)
        del singleq, dpq, resq, want_q
        # samples/s of the f32 engines, in turns (each engine's first pass above)
        rates = {"single program": [], f"data parallel x{N}": []}
        for label, e in (("single program", single), (f"data parallel x{N}", dp),
                         (f"data parallel x{N}", dp), ("single program", single)):
            r = e.run_inference(data, batch_size=BATCH)
            rates[label].append(ROWS / r.seconds)
        print(f"data parallel serving on {smi_line}: {ROWS} rows at batch {BATCH}, samples/s "
              f"in turns (single, dp, dp, single): "
              f"{json.dumps({k: [round(v, 1) for v in vs] for k, vs in rates.items()})}")
        del single, dp
        # the conv engine
        conv_single = Engine.up(conv_model, device=dev)
        conv_dp = Engine.up(conv_model, data_parallel=N, devices=[dev] * N)
        c_batches = math.ceil(CIFAR_ROWS / CIFAR_BATCH)
        streams.clear()
        reset_launch_counts()
        resc = conv_dp.run_inference(data_c, batch_size=CIFAR_BATCH)
        launched = counts()
        slots_ok = (per_slot(conv_dp, "fused_conv2d", c_batches, 2)
                    and per_slot(conv_dp, "fcnn_fused_forward", c_batches, 1))
        want_c = conv_single.run_inference(data_c, batch_size=CIFAR_BATCH).outputs
        ok = (slots_ok and launched["fused_conv2d"] == 2 * N * c_batches
              and launched["fcnn_fused_forward"] == N * c_batches)
        print(f"check data parallel conv engine: {CIFAR_ROWS} rows at batch {CIFAR_BATCH}: "
              f"launches {json.dumps({k: n for k, n in launched.items() if n})} ({c_batches} "
              f"batches; each slot 2 conv and 1 chain launches a batch on its own stream "
              f"{slots_ok}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("data parallel: a conv engine slot did not launch its kernels once a batch")
        compare("data parallel conv engine vs the single-program engine", torch.from_numpy(
            resc.outputs), torch.from_numpy(want_c), *CONV_TOL)
        compare(f"data parallel conv engine, a batch of {CIFAR_BATCH - 1} rows (pad 3)",
                torch.from_numpy(conv_dp.infer(data_c[:CIFAR_BATCH - 1])),
                torch.from_numpy(conv_single.infer(data_c[:CIFAR_BATCH - 1])), *CONV_TOL)
        del conv_single, conv_dp, resc, want_c
    finally:
        for kname, orig in wrapped.items():
            setattr(network, kname, orig)
    torch.cuda.empty_cache()

    # ---------------------------------------------- (b) FCNN training
    class Seen(Optimizer):
        """The optimizer that keeps the gradients it receives."""

        def update(self, grads, state, params, **kw):
            self.seen = [g.detach().clone() for g in grads]
            return super().update(grads, state, params, **kw)

    train = synthetic_mnist(TRAIN_BATCH * (DP["step_runs"] + 1), seed=0)
    bx, by = train.x[:TRAIN_BATCH], train.y[:TRAIN_BATCH]
    seen = {}
    for label, m in (("single program", None), (f"data x{N}", mesh(N))):
        wb, ids = _split_params(params_from_spec(model, device=dev))
        opt = Seen(1e-3, schedule="constant", warmup_steps=0, total_steps=None, clip_norm=None,
                   weight_decay=0.0, grad_accum=1)
        step = make_train_step(ids, opt, mesh=m)
        loss = step(wb, opt.init(_leaves(wb)), torch.from_numpy(bx).to(dev),
                    torch.from_numpy(by).long().to(dev))[2]
        seen[label] = (float(loss), opt.seen)
    (l1, g1), (ln, gn) = seen.values()
    atol, rtol = GRAD_TOL
    g_err = max(float((a - b).abs().max()) for a, b in zip(gn, g1))
    ok = (abs(ln - l1) <= LOSS_RTOL * abs(l1)
          and all(torch.allclose(a, b, atol=atol, rtol=rtol) for a, b in zip(gn, g1)))
    print(f"check data parallel FCNN step 1 (784-128-64-10, batch {TRAIN_BATCH} over {N} data "
          f"slots) vs the single program: loss {ln!r} vs {l1!r}; summed gradients max_abs "
          f"{g_err:.3e} | tol loss rtol {LOSS_RTOL:g}, gradients atol {atol:g} rtol {rtol:g} | "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("data parallel: the FCNN step's gradients differ from the single program's")
    batches = [(train.x[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                train.y[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]) for i in range(DP["step_runs"] + 1)]

    def fcnn_arm(graphed, m):
        wb, ids = _split_params(params_from_spec(model, device=dev))
        opt = build_optimizer(1e-3)
        st = opt.init(_leaves(wb))
        step = make_train_step(ids, opt, mesh=m)
        if graphed:
            run = compile_train_step(step, wb, st, opt, TRAIN_BATCH, MNIST[0])
        else:
            def run(x, y):
                return step(wb, st, torch.as_tensor(x, device=dev),
                            torch.as_tensor(y, dtype=torch.long, device=dev))[2]
        losses = [run(*batches[0]).clone()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for x, y in batches[1:]:
            losses.append(run(x, y).clone())
        torch.cuda.synchronize()
        return ((time.monotonic() - t0) * 1e3 / DP["step_runs"],
                _leaves(wb) + st.mu + st.nu + [st.count] + losses)

    dp_ms = timed_arms({"eager": lambda: fcnn_arm(False, mesh(N)),
                        "graphed": lambda: fcnn_arm(True, mesh(N))})
    single_ms = fcnn_arm(True, None)[0]
    print(f"data parallel FCNN step (784-128-64-10, batch {TRAIN_BATCH} over {N} data slots) "
          f"on {smi_line}, eager and graphed in turns, bit-equal: "
          + "; ".join(f"{label} {ms:.4f} ms/step" for label, ms in dp_ms)
          + f"; the graphed single program {single_ms:.4f} ms/step")
    digits, test = real_digits("train"), real_digits("test")
    p0 = init_fcnn(torch.Generator().manual_seed(0), [64, 128, 64, 10], device="cpu")
    eng_d = Engine.up(spec_from_params(p0, ACTS), data_parallel=N, devices=[dev] * N)
    cfg_d = TrainConfig(epochs=DP["digits_epochs"], batch_size=64, seed=0, lr_schedule="cosine",
                        warmup_steps=50)
    t0 = time.monotonic()
    hist = eng_d.train(digits, cfg_d, eval_data=test)
    acc = hist[-1]["eval"]["accuracy"]
    ok = acc >= DIGITS_RECORD["bar"] and eng_d.data_sharded
    print(f"check data parallel digits recipe through Engine.train on {N} data slots "
          f"({DP['digits_epochs']} epochs, {time.monotonic() - t0:.1f} s): losses "
          f"{[round(h['loss'], 4) for h in hist[::10]]}... {hist[-1]['loss']!r}; held-out "
          f"accuracy {acc!r} (record {DIGITS_RECORD['accuracy']:.4f}) | bar "
          f"{DIGITS_RECORD['bar']} | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("data parallel: the digits recipe on data slots missed the bar")
    del eng_d
    torch.cuda.empty_cache()

    # ------------------------------------------------- (c) the LM arms
    T, B, L = cfg.max_seq_len, LM["batch"], cfg.n_layers
    params = init_transformer(torch.Generator().manual_seed(DP["seed"]), cfg, device=dev)
    names = [n for n, _ in _named_leaves(params)]
    sp_rows = lm_sequences(encode(text), T - 1)
    sp_rows = sp_rows[:max(1, int(len(sp_rows) * 0.95))]
    rows_of = {"plain": train_rows, "sp": sp_rows}
    batches = {}
    for kind, rows in rows_of.items():
        stream = lm_batches(rows, B, seed=DP["seed"], epochs=None)
        batches[kind] = [torch.as_tensor(next(stream), device=dev).long()
                         for _ in range(DP["steps"])]

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

    def no_sdpa(*a, **kw):
        raise RuntimeError("scaled_dot_product_attention called on the data-parallel path")

    def plain_ref(attn, parts):
        """The single program over ``parts`` row groups: loss / parts each,
        gradients summed in the float32 leaves."""
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        loss = 0.0
        for mb in batches["plain"][0].chunk(parts):
            part = lm_loss(p, mb, cfg, attn) / parts
            part.backward()
            loss += float(part.detach())
        return loss, [a.grad for a in param_leaves(p)]

    def sp_ref(attn, parts, chunks):
        """The single program's masked CE over ``parts`` row groups x
        ``chunks`` position chunks, each chunk embedded through its own
        bf16 copy (as each seq slot embeds)."""
        tokens = batches["sp"][0]
        tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        mask = torch.cat([torch.ones((B, T - 1), device=dev),
                          torch.zeros((B, 1), device=dev)], dim=1) / (B * (T - 1))
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        loss = 0.0
        for mb, tg, mk in zip(tokens.chunk(parts), tgt.chunk(parts), mask.chunk(parts)):
            pc = cfg.cast_params(p)
            Tq = T // chunks
            x = torch.cat([embed_at(cfg.cast_params({k: p[k] for k in ("tok_embed", "pos_embed")}),
                                    t, q * Tq) for q, t in enumerate(mb.chunk(chunks, dim=1))],
                          dim=1)
            apply = maybe_remat(cfg)
            for block in unstack_blocks(pc["blocks"]):
                x = apply(block, x, cfg, attn)
            logp = torch.log_softmax(unembed(pc, x).float(), dim=-1)
            part = -(logp.gather(-1, tg[..., None])[..., 0] * mk).sum()
            part.backward()
            loss += float(part.detach())
        return loss, [a.grad for a in param_leaves(p)]

    sdpa = F.scaled_dot_product_attention
    F.scaled_dot_product_attention = no_sdpa
    refs = {}
    for kind, make_ref in (("plain", lambda attn: plain_ref(attn, N)),
                           ("sp", lambda attn: sp_ref(attn, DP["sp_data"], DP["sp_seq"]))):
        flash_ref, dot_ref = make_ref(flash_attention), make_ref(dot_product_attention)
        spread_loss = abs(dot_ref[0] - flash_ref[0]) / abs(flash_ref[0])
        spread = {n: rel(a, b) for n, a, b in zip(names, dot_ref[1], flash_ref[1])}
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in flash_ref[1])))
        clip = DP["clip"] * norm
        clipped = [g * (clip / norm) for g in flash_ref[1]]
        refs[kind] = (flash_ref[0], clipped, clip,
                      max(MP["spread_factor"] * spread_loss, BF16_PARITY_RTOL[0]),
                      {n: max(MP["spread_factor"] * e, 2.0**-8) for n, e in spread.items()})
        print(f"data parallel: 85M bf16 remat on {smi_line}; {kind} reference step 1 (single "
              f"program over the arm's partition): loss {flash_ref[0]!r} (materialised "
              f"{dot_ref[0]!r}: rel {spread_loss:.3e}); global gradient norm {norm:.6g}, "
              f"clip_norm {clip:.6g}; spread a leaf "
              f"{json.dumps({n: float(f'{e:.3e}') for n, e in spread.items()})}")
        del flash_ref, dot_ref
    torch.cuda.empty_cache()

    # (label, kind, data, seq, mode, fsdp)
    ARMS = [(f"ZeRO-1 data {N}", "plain", N, 1, None, False),
            (f"FSDP data {N}", "plain", N, 1, None, True),
            (f"sp x ZeRO-1 ulysses seq {DP['sp_seq']} x data {DP['sp_data']}", "sp",
             DP["sp_data"], DP["sp_seq"], "ulysses", False),
            (f"sp x FSDP ring seq {DP['sp_seq']} x data {DP['sp_data']}", "sp", DP["sp_data"],
             DP["sp_seq"], "ring", True)]

    def make_step(kind, data_, seq, mode, fsdp, opt):
        m = mesh(data_, seq)
        if kind == "sp":
            return zero.make_sp_sharded_lm_train_step(m, cfg, opt, params, mode=mode,
                                                      shard_params=fsdp)
        make = zero.make_fsdp_lm_train_step if fsdp else zero.make_zero_lm_train_step
        return make(m, cfg, opt, params)

    def want_launches(data_, seq, mode):
        if mode == "ring":
            return 0, 0
        return 2 * L * data_ * seq, L * data_ * seq

    def only_flash(launched, want):
        return ({k: n for k, n in launched.items() if n}
                == {k: n for k, n in zip(("flash_fwd_sm90", "flash_bwd_sm90"), want) if n})

    class PerSliceClip(Optimizer):
        """The fault the global norm avoids: each slice clipped by its own
        norm, and no global clip."""

        def apply(self, grads, state, params, **kw):
            clip, self.clip_norm = self.clip_norm, None
            try:
                grads = [torch.where(g.norm() < clip, g, g / g.norm() * clip) for g in grads]
                return super().apply(grads, state, params, **kw)
            finally:
                self.clip_norm = clip

    def step1(label, kind, data_, seq, mode, fsdp, opt_cls=None):
        """Step 1 of an arm: ``(numbers_ok, ok, report)``: the loss and
        first-moment check alone, and with the launches and ownership."""
        loss_ref, g_clip, clip, tol_loss, tol_g = refs[kind]
        opt = (build_optimizer(DP["lr"], total_steps=DP["steps"], clip_norm=clip)
               if opt_cls is None else
               opt_cls(DP["lr"], schedule="constant", warmup_steps=0,
                       total_steps=DP["steps"], clip_norm=clip, weight_decay=0.0, grad_accum=1))
        step = make_step(kind, data_, seq, mode, fsdp, opt)
        p = step.shard_params(tree_map(lambda a: a.detach().clone().requires_grad_(True), params))
        state = step.init_opt_state(param_leaves(p))
        torch.cuda.synchronize()
        reset_launch_counts()
        loss = float(step(p, state, batches[kind][0])[2])
        torch.cuda.synchronize()
        launched = counts()
        mu = [m.whole() if isinstance(m, zero.Shards) else m for m in state.mu]
        errs = {n: rel(m / (1 - B1), g) for n, m, g in zip(names, mu, g_clip)}
        share = {n: errs[n] / tol_g[n] for n in names}
        worst = max(share, key=share.get)
        lrel = abs(loss - loss_ref) / abs(loss_ref)
        want = want_launches(data_, seq, mode)
        # ownership: each slot's elements of every sliced leaf
        owned, whole = [0] * data_, 0
        exact = True
        for i, d in enumerate(step.layout):
            leaves_i = [state.mu[i], state.nu[i]] + ([param_leaves(p)[i]] if fsdp else [])
            for leaf in leaves_i:
                if d is None:
                    whole += leaf.numel()
                    exact &= isinstance(leaf, torch.Tensor)
                    continue
                exact &= isinstance(leaf, zero.Shards) and len(leaf.parts) == data_
                for j, part in enumerate(leaf.parts):
                    owned[j] += part.numel()
                    exact &= part.numel() * data_ == leaf.numel()
        numbers_ok = lrel <= tol_loss and share[worst] <= 1.0
        ok = numbers_ok and only_flash(launched, want) and exact and len(set(owned)) == 1
        report = (f"loss {loss!r} (rel {lrel:.3e}, tol {tol_loss:.3e}); first moment / (1 - b1) "
                  f"vs the clipped reference gradient, relative L2 a leaf "
                  f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})}; largest "
                  f"share of its tolerance {share[worst]:.3f} ({worst}: {errs[worst]:.3e} of "
                  f"{tol_g[worst]:.3e}); owned elements a slot (moments"
                  f"{' and params' if fsdp else ''}, sliced leaves) {owned}, whole leaves on "
                  f"slot 0 {whole}, each sliced leaf exactly 1/{data_} a slot {exact}; launches "
                  f"{json.dumps({k: n for k, n in launched.items() if n})} (expected "
                  f"flash_fwd_sm90 {want[0]}, flash_bwd_sm90 {want[1]}, nothing else)")
        del p, state, step, mu
        torch.cuda.empty_cache()
        return numbers_ok, ok, report

    for label, kind, data_, seq, mode, fsdp in ARMS:
        _, ok, report = step1(label, kind, data_, seq, mode, fsdp)
        print(f"check data parallel {label}, step 1 vs the reference: {report} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"data parallel {label}: step 1 departs from the single program, a slot does "
                 f"not own 1/{data_} of a sliced leaf, or other attention launched")
    passed, _, report = step1(*ARMS[0], opt_cls=PerSliceClip)
    caught = not passed
    print(f"check data parallel {ARMS[0][0]} with each slice clipped by its own norm (a "
          f"deliberate fault): {report} | the check catches it {caught} | "
          f"{'ok' if caught else 'FAIL'}")
    if not caught:
        fail("data parallel: a per-slice clip passed the step-1 check")

    # steps eager (CUDA events) and graphed through train_lm, bit-equal
    summary = {}
    singles = {}
    for kind in ("plain", "sp"):
        host = [b.cpu().numpy() for b in batches[kind]]
        tc = LMTrainConfig(learning_rate=DP["lr"], steps=len(host), batch_size=B,
                           seq_len=host[0].shape[1] - 1, log_every=1, clip_norm=refs[kind][2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, hist = train_lm(params, cfg, host, tc)
        ms = [1e3 * (b["seconds"] - a["seconds"]) for a, b in zip(hist, hist[1:])]
        singles[kind] = (float(np.median(ms)), torch.cuda.max_memory_allocated() / 1e9)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"data parallel: the graphed single program, step p50 (ms) and peak memory (GB) on "
          f"the plain and the sp rows: "
          f"{json.dumps({k: [round(v[0], 3), round(v[1], 3)] for k, v in singles.items()})}")
    for label, kind, data_, seq, mode, fsdp in ARMS:
        host = [b.cpu().numpy() for b in batches[kind]]
        clip = refs[kind][2]
        n_steps = len(host)
        opt = build_optimizer(DP["lr"], total_steps=n_steps, clip_norm=clip)
        step = make_step(kind, data_, seq, mode, fsdp, opt)
        p = step.shard_params(tree_map(lambda a: a.detach().clone().requires_grad_(True), params))
        state = step.init_opt_state(param_leaves(p))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, per_step = [], [], None
        for i, toks in enumerate(batches[kind]):
            if i == 1:
                torch.cuda.synchronize()
                reset_launch_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = step(p, state, toks)[2]
            e1.record()
            torch.cuda.synchronize()
            if i == 1:
                per_step = counts()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 1e9
        p50 = float(np.median(ms[1:]))
        eager = param_leaves(step.unshard_params(p))
        del p, state, step
        torch.cuda.empty_cache()
        want = want_launches(data_, seq, mode)
        ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
              and only_flash(per_step, want))
        tokens = B * host[0].shape[1]
        print(f"check data parallel {label} eager: losses {losses}; step ms "
              f"{[round(t, 3) for t in ms]} (the first includes warm-up); p50 of steps "
              f"2-{len(ms)} {p50:.3f} ms, {tokens / p50 * 1e3:.1f} tokens/s; peak memory "
              f"{peak:.3f} GB; one step's launches "
              f"{json.dumps({k: n for k, n in per_step.items() if n})} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"data parallel {label}: losses not finite and falling, or other launches")
        m_ = (data_, seq, mode, fsdp)
        tc = LMTrainConfig(learning_rate=DP["lr"], steps=n_steps, batch_size=B,
                           seq_len=host[0].shape[1] - 1, log_every=1, clip_norm=clip)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trained, hist = train_lm(params, cfg, host, tc,
                                 step_fn=lambda o, m_=m_: make_step(kind, *m_, o))
        torch.cuda.synchronize()
        g_launched, g_peak = counts(), torch.cuda.max_memory_allocated() / 1e9
        g_losses = [h["loss"] for h in hist]
        g_ms = [1e3 * (b["seconds"] - a["seconds"]) for a, b in zip(hist, hist[1:])]
        g_p50 = float(np.median(g_ms))
        differ = sum(int((a != b).sum()) for a, b in zip(param_leaves(trained), eager))
        total = (want[0] * n_steps, want[1] * n_steps)
        ok = g_losses == losses and differ == 0 and only_flash(g_launched, total)
        single_p50, single_peak = singles[kind]
        print(f"check data parallel {label} graphed (train_lm) vs eager over {n_steps} steps: "
              f"losses bit-equal {g_losses == losses}; trained parameter elements not "
              f"bit-equal {differ}; launches "
              f"{json.dumps({k: n for k, n in g_launched.items() if n})} (expected {total[0]} + "
              f"{total[1]}); step ms (host clock) {[round(t, 3) for t in g_ms]} after the first "
              f"(warm-up and capture, {1e3 * hist[0]['seconds']:.1f} ms); p50 graphed "
              f"{g_p50:.3f} ms, eager {p50:.3f} ms, the graphed single program "
              f"{single_p50:.3f} ms ({g_p50 / single_p50:.2f}x it), {tokens / g_p50 * 1e3:.1f} "
              f"tokens/s; peak memory graphed {g_peak:.3f} GB, eager {peak:.3f}, the graphed "
              f"single program {single_peak:.3f} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"data parallel {label}: the graphed step departs from the eager one")
        summary[label] = dict(eager_ms=round(p50, 3), graphed_ms=round(g_p50, 3),
                              single_graphed_ms=round(single_p50, 3),
                              tokens_per_s=round(tokens / g_p50 * 1e3, 1),
                              peak_gb_eager=round(peak, 3), peak_gb_graphed=round(g_peak, 3),
                              peak_gb_single=round(single_peak, 3),
                              flash_launches_a_step=list(want))
        del trained, eager
        gc.collect()
        torch.cuda.empty_cache()
    F.scaled_dot_product_attention = sdpa
    print("data parallel LM steps: " + json.dumps(summary))
    del params
    torch.cuda.empty_cache()
    print(f"data parallel phase: {time.monotonic() - t_phase:.1f} s")



def _named_leaves(tree, prefix=""):
    """``(path, tensor)`` in ``param_leaves`` order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_named_leaves(v, f"{prefix}{key}/") if isinstance(v, dict)
                   else [(prefix + key, v)])
    return out


GUARD_ARMS = ("on", "off", "off", "on", "on", "off")  # the guard's cost, Process rows/s in turns
POISON_REQS = 8  # Process requests of 7 rows beside the poisoned one (F8)


def guard_phase(dev, model, data, out_dir, smi_line) -> None:
    """The numeric guard on the Process path (F8's repair) on the relu
    MNIST engine, whose kernels keep a NaN since F9's: a poisoned request
    among coalesced neighbours fails DATA_LOSS alone, the neighbours
    bit-equal to their solo replies, through the chain kernel; then the
    guard's cost on Process rows/s, armed and disarmed in turns."""
    import threading

    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import save_model
    from tpu_dist_nn_torch.kernels import fcnn_fused_forward, reset_launch_counts
    from tpu_dist_nn_torch.serving import integrity
    from tpu_dist_nn_torch.serving.server import Batcher, RpcAbort, make_process_handler
    from tpu_dist_nn_torch.serving.wire import decode_matrix, encode_matrix

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        mnist_path = Path(tmp) / "mnist.json"
        save_model(model, mnist_path)
        eng = eng_mnist = Engine.up(mnist_path, device=dev)
    rng = np.random.default_rng(7)
    rows = [rng.uniform(0.0, 1.0, (7, MNIST[0])).astype(np.float32) for _ in range(POISON_REQS)]
    victim = POISON_REQS // 2
    rows[victim][3] = np.nan
    solo = [eng.infer(r) if i != victim else None for i, r in enumerate(rows)]
    # A large clean request first holds the dispatch thread, so the
    # others queue behind it and coalesce into ONE launch: the engine's
    # first launch waits at a gate until all of them are queued.
    head = rng.uniform(0.0, 1.0, (BATCH, MNIST[0])).astype(np.float32)

    class Gated:
        model, numpy_dtype, fetch = eng.model, eng.numpy_dtype, eng.fetch
        gate = threading.Event()

        def infer_async(self, x):
            self.gate.wait(60.0)
            return eng.infer_async(x)

    gated = Gated()
    batcher = Batcher(gated, pipeline_depth=1)
    handler = make_process_handler(gated, batcher)
    replies = [None] * POISON_REQS
    reset_launch_counts()

    def send(i):
        try:
            replies[i] = decode_matrix(handler(encode_matrix(rows[i]))[0])
        except RpcAbort as e:
            replies[i] = e

    def wait_for(cond):
        t0 = time.monotonic()
        while not cond():
            if time.monotonic() - t0 > 60.0:
                fail("F8 check: the Process requests never queued")
            time.sleep(1e-4)

    first = threading.Thread(target=lambda: handler(encode_matrix(head)))
    first.start()
    wait_for(lambda: batcher.requests_total == 1 and batcher.pending_rows == 0)
    pool = [threading.Thread(target=send, args=(i,)) for i in range(POISON_REQS)]
    for th in pool:
        th.start()
    wait_for(lambda: batcher.pending_rows == 7 * POISON_REQS)
    Gated.gate.set()
    for th in pool + [first]:
        th.join()
    launches = fcnn_fused_forward.launches
    batches = batcher.batches_total
    batcher.close()
    bad = replies[victim]
    clean = [i for i in range(POISON_REQS) if i != victim]
    diff = sum(int((replies[i] != solo[i].astype(np.float64)).sum()) for i in clean
               if not isinstance(replies[i], RpcAbort))
    aborted = [i for i in clean if isinstance(replies[i], RpcAbort)]
    ok = (isinstance(bad, RpcAbort) and bad.code == "DATA_LOSS" and not aborted and diff == 0
          and batches == 2 and launches == batches)
    print(f"check F8 Process guard: {POISON_REQS} requests of 7 rows behind one of {BATCH} in "
          f"{batches} launches (chain launches {launches}), row 3 of request {victim} NaN: "
          f"{getattr(bad, 'code', 'not aborted')} {getattr(bad, 'message', '')!r}; its "
          f"neighbours aborted {len(aborted)}, not-bit-equal to their solo replies {diff} | "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the numeric guard did not fail the poisoned Process request alone")
    try:
        eng.infer(rows[victim])
        direct = "returned"
    except Exception as e:  # noqa: BLE001 — printed, then checked
        direct = type(e).__name__
    print(f"check F8 Engine.infer on the poisoned rows raises IntegrityError: {direct} | "
          f"{'ok' if direct == 'IntegrityError' else 'FAIL'}")
    if direct != "IntegrityError":
        fail("Engine.infer shipped non-finite rows")
    # F9: the chain kernel itself on the poisoned rows (no guard): the
    # NaN row comes out non-finite, the others finite.
    from tpu_dist_nn_torch.models.fcnn import params_from_spec

    raw = fcnn_fused_forward(params_from_spec(model, device=dev),
                             torch.from_numpy(rows[victim]).to(dev)).cpu().numpy()
    finite = np.isfinite(raw).all(axis=1)
    f9_ok = finite.tolist() == [i != 3 for i in range(len(raw))]
    print(f"check F9 relu MNIST chain kernel on the poisoned rows: finite rows "
          f"{finite.astype(int).tolist()} (row 3 NaN in) | {'ok' if f9_ok else 'FAIL'}")
    if not f9_ok:
        fail("the chain kernel's relu dropped a NaN (F9)")

    # The guard's cost: the Process path's 60,000 rows (sizes in turn,
    # 10 threads, depth 2) with the guard armed and disarmed in turns.
    # In the armed passes the guard's own work (``bad_rows`` on each
    # fetched array, where Engine.fetch calls it) is timed directly: the
    # rates alone spread more than the guard could cost.
    reqs = process_requests(len(data))
    payloads = [encode_matrix(data[a:b]) for a, b in reqs]
    rates = {"on": [], "off": []}
    guard = integrity.GUARD
    plain_bad_rows = guard.bad_rows
    spent = []  # (seconds, rows) of each bad_rows call in the armed passes
    shares = []  # (the guard's seconds, calls, the pass's wall) of each armed pass

    def timed_bad_rows(out):
        t1 = time.perf_counter()
        bad = plain_bad_rows(out)
        spent.append((time.perf_counter() - t1, len(out)))
        return bad

    guard.bad_rows = timed_bad_rows
    try:
        for arm in GUARD_ARMS:
            guard.enabled = arm == "on"
            spent.clear()
            b = Batcher(eng_mnist, pipeline_depth=2)
            h = make_process_handler(eng_mnist, b)
            t0 = time.perf_counter()
            got, _ = drive_handler(h, payloads)
            wall = time.perf_counter() - t0
            b.close()
            if any(isinstance(r, RpcAbort) for r in got):
                fail(f"a Process request aborted in the guard-cost arm {arm}")
            rates[arm].append(len(data) / wall)
            if arm == "on":
                if sum(n for _, n in spent) < len(data):
                    fail(f"the armed guard screened {sum(n for _, n in spent)} of "
                         f"{len(data)} rows")
                shares.append((sum(t for t, _ in spent), len(spent), wall))
    finally:
        del guard.bad_rows  # the method again
        guard.enabled = True
    on, off = np.median(rates["on"]), np.median(rates["off"])
    rel_spread = max((max(v) - min(v)) / np.median(v) for v in rates.values())
    share = max(t / w for t, _, w in shares)
    print(f"guard cost on Process f32 ({len(data)} rows, {len(reqs)} requests, 10 threads, "
          f"depth 2) on {smi_line}: armed {on:.1f} rows/s (runs "
          f"{json.dumps([round(r, 1) for r in rates['on']])}), disarmed {off:.1f} rows/s (runs "
          f"{json.dumps([round(r, 1) for r in rates['off']])}); median difference "
          f"{(off - on) / off * 100:+.2f}% of disarmed, run-to-run spread within an arm up to "
          f"{rel_spread * 100:.2f}% of its median")
    print(f"guard cost, timed directly: bad_rows took "
          f"{json.dumps([round(t * 1e3, 4) for t, _, _ in shares])} ms over "
          f"{json.dumps([n for _, n, _ in shares])} fetched arrays in the armed passes of "
          f"{json.dumps([round(w * 1e3, 1) for _, _, w in shares])} ms wall: at most "
          f"{share * 100:.4f}% of the Process time (host clock), "
          f"{'inside' if share < rel_spread else 'NOT inside'} the run-to-run spread "
          f"({rel_spread * 100:.2f}%)")
    print(f"guard phase took {time.monotonic() - t_phase:.1f} s")


PIPE_DEVICES = 3  # [1, 1, 1]: three stage slots (streams) on one card
PIPE_MICROBATCHES = 4
PIPE_CHURN_RUNS = 20
GRAD_TOL = (1e-6, 1e-4)  # atol, rtol: tests/test_pipeline_1f1b.py's gradients
LOSS_RTOL = 1e-5  # and its losses


def pipeline_phase(dev, model, data, resq, he_model, out_dir, smi_line, failures) -> None:
    """The layer-distribution pipeline on one card: ``[1, 1, 1]`` on
    three stage slots (one stream each) of ``dev``, f32 and int8, the
    interleaved placement of the 34-layer model, ``step_latency``,
    allocator churn, and training through the GPipe and 1F1B schedules
    (the digits record's recipe through ``[1, 1, 1]`` with 1F1B, and one
    full-width epoch of each)."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import load_model, partition_model, save_model
    from tpu_dist_nn_torch.data.datasets import Dataset, real_digits, synthetic_mnist
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        fcnn_quantized_forward,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.kernels.fused_dense import activation_ids, chain_plan, int8_plan
    from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.pipeline import build_pipeline_params, run_placed
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.train.metrics import classification_metrics
    from tpu_dist_nn_torch.train.pipeline_trainer import (
        pipeline_loss_and_grad,
        prepare_pipeline_batch,
        train_pipelined,
    )
    from tpu_dist_nn_torch.train.trainer import TrainConfig
    from tpu_dist_nn_torch.utils.profiling import cuda_graph_time_ms

    print(f"pipeline path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    slots = [dev] * PIPE_DEVICES
    M = PIPE_MICROBATCHES

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        tmp = Path(tmp)
        model_path = tmp / "mnist_fcnn.json"
        save_model(model, model_path)
        one = Engine.up(model_path)
        onq = Engine.up(model_path, quantize="int8")
        eng = Engine.up(model_path, [1, 1, 1], devices=slots, num_microbatches=M)
        engq = Engine.up(model_path, [1, 1, 1], devices=slots, num_microbatches=M,
                         quantize="int8")
        place = eng.placement()
        print(f"pipelined placement: {json.dumps(place)}")
        if not place["pipelined"] or place["num_stages"] != 3:
            fail("Engine.up(model, [1, 1, 1], devices=3 slots) did not place a 3-stage pipeline")

        # (a) 60,000 rows at batch 8,192, f32 and int8, beside the single
        # program in turns (one, pipeline, pipeline, one).
        n_batches = math.ceil(ROWS / BATCH)
        runs = {}
        for label, e in (("one f32", one), ("pipeline f32", eng), ("pipeline f32 ", eng),
                         ("one f32 ", one), ("one int8", onq), ("pipeline int8", engq),
                         ("pipeline int8 ", engq), ("one int8 ", onq)):
            reset_launch_counts()
            res = e.run_inference(data, batch_size=BATCH)
            runs.setdefault(label.strip(), []).append((res, counts()))
        for label, got in runs.items():
            for res, c in got:
                lat = res.latency_summary()
                print(f"{label}: {ROWS / res.seconds:.1f} samples/s ({res.seconds:.4f} s for "
                      f"{ROWS} rows at batch {BATCH}), batch p50 {lat['p50_s'] * 1e3:.3f} ms; "
                      f"launches {json.dumps({k: n for k, n in c.items() if n})}")
        want_launches = {"pipeline f32": ("fcnn_fused_forward", 3 * M * n_batches),
                         "pipeline int8": ("fcnn_quantized_forward", 3 * M * n_batches)}
        for label, (kname, n) in want_launches.items():
            got = [c[kname] for _, c in runs[label]]
            ok = got == [n, n]
            print(f"check {label} launches: {kname} {got} per run, expected stages x "
                  f"microbatches x batches = 3 x {M} x {n_batches} = {n} | "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the pipelined {label} run did not launch {kname} once a stage a "
                     "microbatch")
        res32 = runs["pipeline f32"][0][0]
        o_err = float(np.abs(res32.outputs - oracle_forward_batch(model, data)).max())
        print(f"check pipeline f32 vs float64 oracle ({ROWS} rows): max_abs {o_err:.3e} | "
              f"tol atol 1e-05 | {'ok' if o_err <= 1e-5 else 'FAIL'}")
        if o_err > 1e-5:
            fail("the pipelined f32 outputs disagree with the float64 oracle")
        for label, ref in (("pipeline int8", resq.outputs),
                           ("pipeline int8 (second run)", runs["pipeline int8"][1][0].outputs)):
            got = runs["pipeline int8"][0][0].outputs
            diff = int((got != ref).sum())
            print(f"check {label} vs the single-program int8 engine: not-bit-equal {diff} | "
                  f"{'ok' if diff == 0 else 'FAIL'}")
            if diff:
                fail("the int8 pipeline is not bit-equal to the single-program int8 engine")

        # The chain at the pipeline's row split: each stage's launch on
        # 2,048 rows (8,192 in 4 microbatches) beside the whole chain on
        # 8,192; device time (a CUDA graph of 50 calls), TF32 off.
        xd = torch.from_numpy(data[:BATCH]).to(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, stages, whole, fn in (
                ("f32", eng._placed.chunks[0], one._params, fcnn_fused_forward),
                ("int8", engq._q.chunks[0], onq._q, fcnn_quantized_forward)):
            h, per_stage = xd[:BATCH // M], []
            for layers in stages:
                per_stage.append(cuda_graph_time_ms(lambda h=h, layers=layers: fn(layers, h)))
                h = fn(layers, h)
            ms_whole = cuda_graph_time_ms(lambda: fn(whole, xd))
            dims0 = [MNIST[0], MNIST[1]]
            plan = (chain_plan(dims0, activation_ids(ACTS[:1]), BATCH // M, sms,
                               torch.cuda.current_device()) if label == "f32"
                    else int8_plan(dims0, BATCH // M, sms))
            print(f"time {label} stage launches at {BATCH // M} rows: "
                  f"{', '.join(f'{ms:.4f}' for ms in per_stage)} ms (stages 1-3), x {M} "
                  f"microbatches = {M * sum(per_stage):.4f} ms a batch, vs the whole chain at "
                  f"{BATCH} rows {ms_whole:.4f} ms; stage 1's plan at {BATCH // M} rows: {plan}")

        # (b) One batch 20 times under allocator churn, every run in
        # flight before the first fetch: bit-equal run to run.
        xb = data[:BATCH]
        ref = eng.infer(xb)
        pending = []
        reset_launch_counts()
        junk_rng = np.random.default_rng(1)
        for _ in range(PIPE_CHURN_RUNS):
            pending.append(eng.infer_async(xb))
            for row in eng.mesh.slots:
                with torch.cuda.stream(row[0].stream):
                    n = int(junk_rng.integers(1 << 16, 1 << 20))
                    torch.empty(n, device=dev).fill_(float("nan"))
            torch.empty(int(junk_rng.integers(1 << 16, 1 << 20)), device=dev).fill_(float("nan"))
        outs = [eng.fetch(p) for p in pending]
        churn_launches = counts()["fcnn_fused_forward"]
        diff = sum(int((o != ref).sum()) for o in outs)
        ok = diff == 0 and churn_launches == 3 * M * PIPE_CHURN_RUNS
        print(f"check {PIPE_CHURN_RUNS} runs of one {BATCH}-row batch in flight together under "
              f"allocator churn (NaN-filled blocks on every stage stream): not-bit-equal {diff}, "
              f"chain launches {churn_launches} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("pipelined runs under allocator churn are not bit-equal run to run")

        # (c) step_latency, pipelined (the captured forward) and single
        # program; then the pipelined forward of 256 rows eager
        # (run_placed) and graphed, each with its copy back to the host.
        for label, e in (("pipeline [1, 1, 1]", eng), ("one program", one)):
            lat = e.step_latency(batch_size=256)
            print(f"step_latency {label} at batch 256 on {smi_line}: p50 "
                  f"{lat['p50_s'] * 1e3:.4f} ms, p99 {lat['p99_s'] * 1e3:.4f} ms, num_stages "
                  f"{lat['num_stages']}, p50_per_stage {lat['p50_per_stage_s'] * 1e3:.4f} ms")
        graphed = eng._graphed(eng._placed)
        for rows in (256, BATCH):
            xr = torch.from_numpy(data[:rows]).to(dev)
            p50 = {}
            for label, fn in (("eager", lambda: run_placed(eng._placed, xr, M).cpu()),
                              ("graphed", lambda: graphed(xr).cpu()),
                              ("graphed ", lambda: graphed(xr).cpu()),
                              ("eager ", lambda: run_placed(eng._placed, xr, M).cpu())):
                fn()
                times = []
                for _ in range(50):
                    t0 = time.monotonic()
                    fn()
                    times.append(time.monotonic() - t0)
                p50.setdefault(label.strip(), []).append(float(np.median(times)) * 1e3)
            diff = int((graphed(xr) != run_placed(eng._placed, xr, M)).sum())
            print(f"check pipelined forward of {rows} rows on [1, 1, 1], graphed vs eager on "
                  f"{smi_line}: p50 {p50['graphed']} vs {p50['eager']} ms (host clock, the "
                  f"copy to the host included, in turns); not-bit-equal {diff} | "
                  f"{'ok' if diff == 0 else 'FAIL'}")
            if diff:
                fail("the graphed pipelined forward is not bit-equal to the eager one")

        # (d) The interleaved placement of the 34-layer model: [9, 9, 8, 8]
        # at virtual_stages 2 on two slots, f32 and int8.
        dims34 = [16] * 35
        model34 = he_model(dims34, ["relu"] * 33 + ["softmax"], seed=len(dims34) + dims34[1])
        x34 = np.random.default_rng(34).uniform(0.0, 1.0, (2048, 16)).astype(np.float32)
        for quant in (None, "int8"):
            single = Engine.up(model34, quantize=quant).infer(x34)
            e34 = Engine.up(model34, [9, 9, 8, 8], virtual_stages=2, devices=[dev] * 2,
                            num_microbatches=M, quantize=quant)
            reset_launch_counts()
            got = e34.infer(x34)
            c = counts()
            kname = "fcnn_quantized_forward" if quant else "fcnn_fused_forward"
            label = f"interleaved 34-layer [9, 9, 8, 8] v=2 {quant or 'f32'}"
            if quant:
                diff = int((got != single).sum())
                ok = diff == 0
                detail = f"not-bit-equal to the single-program int8 engine {diff}"
            else:
                e_one = float(np.abs(got - single).max())
                e_orc = float(np.abs(got - oracle_forward_batch(model34, x34)).max())
                ok = e_one <= 1e-5 and e_orc <= 1e-5
                detail = (f"max_abs vs the single-program engine {e_one:.3e}, vs the float64 "
                          f"oracle {e_orc:.3e} (tol atol 1e-05)")
            ok = ok and c[kname] == 4 * M
            print(f"check {label}: placement {e34.placement()['slots']}, {detail}, {kname} "
                  f"launches {c[kname]} (4 chunks x {M} microbatches) | {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the {label} engine disagrees with its single-program engine")

        # (e) The digits record's recipe through [1, 1, 1] with 1F1B.
        digits, test = real_digits("train"), real_digits("test")
        sizes, acts = [64, 128, 64, 10], ["relu", "relu", "softmax"]
        spec = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), sizes, acts,
                                          device="cpu"), acts)
        eng_d = Engine.up(spec, [1, 1, 1], devices=slots, num_microbatches=M)
        cfg_d = TrainConfig(epochs=40, batch_size=64, lr_schedule="cosine", warmup_steps=50,
                            seed=0)
        t0 = time.monotonic()
        hist = eng_d.train(digits, cfg_d, eval_data=test, schedule="1f1b")
        wall = time.monotonic() - t0
        steps = len(digits) // 64
        acc = hist[-1]["eval"]["accuracy"]
        exported = tmp / "digits_1f1b.json"
        eng_d.export(exported, metrics=hist[-1]["eval"])
        served = Engine.up(load_model(exported), [3]).infer(test.x)
        served_acc = classification_metrics(served, test.y, 10)["accuracy"]
        ok = acc >= DIGITS_RECORD["bar"] and served_acc == acc
        print(f"check digits recipe through [1, 1, 1] with schedule 1f1b: {wall:.2f} s for 40 "
              f"epochs ({wall / (40 * steps) * 1e3:.3f} ms/step with eval), losses "
              f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.6f}, held-out accuracy {acc:.4f} "
              f"F1 {hist[-1]['eval']['f1_score']:.4f} (bar {DIGITS_RECORD['bar']}); the "
              f"exported model on one program {served_acc!r} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the digits recipe through the 1F1B pipeline missed 0.97 held-out, or the "
                 "exported model serves at another accuracy")

        # (f) One full-width epoch: gpipe and 1f1b beside one program.
        full = synthetic_mnist(TRAIN_ROWS, seed=0)
        train = Dataset(full.x, full.y, 10)
        spec = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), MNIST, ACTS,
                                          device="cpu"), ACTS)
        pp = build_pipeline_params(partition_model(spec, [1, 1, 1]))
        mesh = build_mesh(MeshSpec(stage=3), slots)
        batch = prepare_pipeline_batch(pp.meta, full.x[:TRAIN_BATCH], full.y[:TRAIN_BATCH], M, 1)
        first = {s: pipeline_loss_and_grad(mesh, pp, *batch, schedule=s, num_microbatches=M)
                 for s in ("gpipe", "1f1b")}
        (lg, gg), (lf, gf) = first["gpipe"], first["1f1b"]
        g_err = max(float(np.abs(a - b).max()) for a, b in ((gg.w, gf.w), (gg.b, gf.b)))
        ok = (abs(lg - lf) <= LOSS_RTOL * abs(lg)
              and all(np.allclose(a, b, atol=GRAD_TOL[0], rtol=GRAD_TOL[1])
                      for a, b in ((gg.w, gf.w), (gg.b, gf.b))))
        print(f"check first-step loss and grads, gpipe vs 1f1b (784-128-64-10, batch "
              f"{TRAIN_BATCH}, {M} microbatches): loss {lg!r} vs {lf!r}, grads max_abs "
              f"{g_err:.3e} | tol loss rtol {LOSS_RTOL:g}, grads atol {GRAD_TOL[0]:g} rtol "
              f"{GRAD_TOL[1]:g} | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("gpipe vs 1f1b first step")
        steps = TRAIN_ROWS // TRAIN_BATCH
        cfg = TrainConfig(epochs=1, batch_size=TRAIN_BATCH, seed=0)
        one_t = Engine.up(spec)
        reset_launch_counts()
        for label in ("gpipe", "1f1b", "one program"):
            if label == "one program":
                h = one_t.train(train, cfg)
            else:
                _, h = train_pipelined(pp, mesh, train, cfg, num_microbatches=M, schedule=label)
            sec = h[0]["seconds"]
            print(f"train 784-128-64-10 one epoch, {label}: loss {h[0]['loss']:.6f}, {sec:.3f} s "
                  f"({steps} steps of {TRAIN_BATCH}: {sec / steps * 1e3:.4f} ms/step, "
                  f"{steps * TRAIN_BATCH / sec:.1f} samples/s)")
            if not math.isfinite(h[0]["loss"]):
                failures.append(f"{label} epoch loss")
        if any(counts().values()):
            failures.append(f"training launched a kernel: {counts()}")

        # (g) The pipelined step eager and graphed, each schedule, batch
        # 64 (BASELINE's headline: >= 10,000 samples/s through a 3-stage
        # layer pipeline), bit for bit equal.
        for sched, dist, v in (("gpipe", [1, 1, 1], 1), ("1f1b", [1, 1, 1], 1),
                               ("interleaved", [1, 1, 1, 0], 2)):
            arms = pipeline_step_arms(dev, spec, train, sched, dist, v, GRAPH_STEPS)
            print(f"pipelined step {sched} on {dist} ({len(dist) // v} slots of the card, {M} "
                  f"microbatches), 784-128-64-10 at batch {TRAIN_BATCH} on {smi_line}: "
                  + "; ".join(f"{label} {ms:.4f} ms/step ({TRAIN_BATCH / ms * 1e3:.1f} "
                              f"samples/s)" for label, ms in arms)
                  + f"; BASELINE's bar 10000 samples/s")

        # (h) BASELINE configs[2] (artifacts/deep_pipeline_r04/RECORD.json):
        # 64-96-80-64-48-32-24-16-10 on [1] * 8, eight stage slots of the
        # card (the record ran eight devices), 30 epochs of the vendored
        # digits at batch 64, Adam 1e-3, 4 microbatches, gpipe; held-out
        # accuracy against the record's 0.9861 and the 0.97 bar.
        deep = [64, 96, 80, 64, 48, 32, 24, 16, 10]
        acts8 = ["relu"] * 7 + ["softmax"]
        spec8 = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), deep, acts8,
                                           device="cpu"), acts8)
        eng8 = Engine.up(spec8, [1] * 8, devices=[dev] * 8, num_microbatches=M)
        t0 = time.monotonic()
        hist8 = eng8.train(digits, TrainConfig(epochs=30, batch_size=64, learning_rate=1e-3),
                           eval_data=test)
        wall8 = time.monotonic() - t0
        acc8 = hist8[-1]["eval"]["accuracy"]
        lat8 = eng8.step_latency(batch_size=256, iters=30)
        ok = acc8 >= DIGITS_RECORD["bar"]
        print(f"check BASELINE configs[2] (64-96-80-64-48-32-24-16-10 on [1] * 8, eight slots "
              f"of the card) on {smi_line}: 30 epochs in {wall8:.2f} s "
              f"({wall8 / (30 * (len(digits) // 64)) * 1e3:.3f} ms/step with eval), losses "
              f"{hist8[0]['loss']:.4f} -> {hist8[-1]['loss']:.6f}, held-out accuracy {acc8:.4f} "
              f"F1 {hist8[-1]['eval']['f1_score']:.4f} (record 0.9861 on eight devices; bar "
              f"{DIGITS_RECORD['bar']}); step_latency at 256 p50 {lat8['p50_s'] * 1e3:.4f} ms, "
              f"per stage {lat8['p50_per_stage_s'] * 1e3:.4f} ms | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("BASELINE configs[2] missed 0.97 held-out")
    if failures:
        fail(f"pipeline checks failed: {failures}")
    print(f"pipeline phase took {time.monotonic() - t_phase:.1f} s")


def main() -> None:
    if not (ROOT / "tpu_dist_nn_torch" / "kernels" / "csrc").is_dir():
        fail("tpu_dist_nn_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    t_main = time.monotonic()

    def mark(label: str) -> None:
        """The script's elapsed time at a path's start (its budget is 1200 s)."""
        print(f"chip_smoke: {label} at {time.monotonic() - t_main:.1f} s", flush=True)

    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.cli import main as cli_main
    from tpu_dist_nn_torch.core.activations import apply_activation
    from tpu_dist_nn_torch.core.schema import LayerSpec, ModelSpec, save_examples, save_model
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        _build,
        fcnn_fused_forward,
        fcnn_fused_forward_plain,
        fcnn_quantized_forward,
        flash_bwd,
        flash_bwd_f32,
        flash_bwd_plain,
        flash_bwd_sm90,
        flash_fwd,
        flash_fwd_f32,
        flash_fwd_plain,
        flash_fwd_sm90,
        forward_quantized,
        fused_conv2d,
        fused_conv2d_plain,
        fused_dense,
        fused_dense_plain,
        quantize_fcnn,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences, load_corpus
    from tpu_dist_nn_torch.kernels.flash_attention import bf16_rounding_bounds, flash_attention
    from tpu_dist_nn_torch.kernels.conv2d import conv_plan
    from tpu_dist_nn_torch.kernels.fused_dense import (
        _buffer_widths,
        _chain_smem,
        activation_ids,
        chain_plan,
        chain_segments,
        dense_plan,
        int8_plan,
        max_clusters,
    )
    from tpu_dist_nn_torch.models.fcnn import params_from_spec
    from tpu_dist_nn_torch.models.transformer import (
        TransformerConfig,
        dot_product_attention,
        init_transformer,
        lm_loss,
        num_params,
        param_leaves,
        tree_map,
    )
    from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, evaluate_lm, train_lm
    from tpu_dist_nn_torch.models.network import (
        build_network,
        dense_forward,
        init_conv_mlp,
        network_forward,
    )
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.utils.profiling import LatencyStats, cuda_graph_time_ms, cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The int8 warm-up gate may reroute a quantized engine to the f32
    # chain where its host-bound timing says int8 is slower; every int8
    # check below holds the int8 kernel itself, so the gate only
    # measures and warns (the CLI subprocesses inherit this). The train
    # phase turns it on for its own gate check.
    os.environ["TDN_INT8_AUTO"] = "0"
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {name} x{torch.cuda.device_count()}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    print("card (nvidia-smi name, power.limit):")
    print(smi[0])
    part, (mem_rate, f32_rate, i8_rate, bf16_rate, tf32_rate) = peaks_for(name)
    print(f"peaks used for bounds (H100 {part} data sheet): {mem_rate / 1e12:g} TB/s, "
          f"{f32_rate / 1e12:g} TFLOP/s FP32, {i8_rate / 1e12:g} TOP/s INT8, "
          f"{bf16_rate / 1e12:g} TFLOP/s BF16, {tf32_rate / 1e12:g} TFLOP/s TF32")

    # ---------------------------------------------------------- 1. build
    t0 = time.monotonic()
    _build.launcher("fused_dense")
    print(f"kernel build: {_build.build_seconds:.1f} s compile, "
          f"{time.monotonic() - t0:.1f} s with load")
    for lib in _build.LIBRARIES:
        log = _build.library_path(lib).with_suffix(".log")
        for line in log.read_text().splitlines() if log.is_file() else []:
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {lib}: {line.split('ptxas info    :')[-1].strip()}")

    # ------------------------------------- 2. kernels vs plain versions
    mark("kernel checks")
    rng = np.random.default_rng(0)
    failures: list[str] = []

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, got, want, atol, rtol):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        max_abs = float(diff.max()) if diff.numel() else 0.0
        max_rel = (float((diff / want.float().abs().clamp_min(max(atol, 1e-30))).max())
                   if diff.numel() else 0.0)
        ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
              and bool(torch.allclose(got, want, atol=atol, rtol=rtol)))
        exact = int((got != want).sum())
        print(f"check {label}: shape {tuple(got.shape)} max_abs {max_abs:.3e} "
              f"max_rel {max_rel:.3e} not-bit-equal {exact} | tol atol {atol:g} "
              f"rtol {rtol:g} | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return max_abs

    def he_model(sizes, acts, seed):
        r = np.random.default_rng(seed)
        layers = []
        for i, act in enumerate(acts):
            fi, fo = sizes[i], sizes[i + 1]
            layers.append(LayerSpec(
                weights=r.normal(0.0, math.sqrt(2.0 / fi), (fi, fo)),
                biases=r.normal(0.0, 0.05, (fo,)),
                activation=act,
                type_tag="output" if i == len(acts) - 1 else "hidden",
            ))
        return ModelSpec(layers=layers)

    model = he_model(MNIST, ACTS, seed=1)
    params = params_from_spec(model, device=dev)
    x = on_card(rng.uniform(0.0, 1.0, (BATCH, MNIST[0])).astype(np.float32))
    w1, b1 = params[0]["w"], params[0]["b"]
    err = {}

    # fused_dense: the flagship's first layer under every activation, the
    # softmax head (N = 10), and a ragged M. f32 FFMA vs cuBLAS f32.
    for act in ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"]:
        e = compare(f"fused_dense 8192x784->128 {act}", fused_dense(x, w1, b1, activation=act),
                    fused_dense_plain(x, w1, b1, act), 1e-5, 1e-5)
        if act == "relu":
            err["fused_dense"] = e
    h2 = on_card(rng.uniform(0.0, 1.0, (BATCH, 64)).astype(np.float32))
    compare("fused_dense 8192x64->10 softmax",
            fused_dense(h2, params[2]["w"], params[2]["b"], activation="softmax"),
            fused_dense_plain(h2, params[2]["w"], params[2]["b"], "softmax"), 1e-5, 1e-5)
    compare("fused_dense 8191x784->128 relu (ragged M)",
            fused_dense(x[:8191], w1, b1, activation="relu"),
            fused_dense_plain(x[:8191], w1, b1, "relu"), 1e-5, 1e-5)

    # fcnn_fused_forward: tolerance of tests/test_kernels.py's chain checks.
    err["fcnn_fused_chain"] = compare(
        "fcnn_fused_forward 784-128-64-10 f32 x8192",
        fcnn_fused_forward(params, x), fcnn_fused_forward_plain(params, x), 2e-5, 1e-4)
    compare("fcnn_fused_forward 784-128-64-10 f32 x8191 (ragged)",
            fcnn_fused_forward(params, x[:8191]), fcnn_fused_forward_plain(params, x[:8191]),
            2e-5, 1e-4)
    xu8 = on_card(rng.integers(0, 256, (BATCH, MNIST[0])).astype(np.uint8))
    compare("fcnn_fused_forward 784-128-64-10 uint8 x8192 input_scale=1/255",
            fcnn_fused_forward(params, xu8, input_scale=1.0 / 255.0),
            fcnn_fused_forward_plain(params, xu8, input_scale=1.0 / 255.0), 2e-5, 1e-4)

    # The f32 tile's schedules: the planners' choices at the main shapes;
    # split-K across a cluster (the conv network's 2048-64-10 dense tail
    # at batch 1024, its ragged 1023, 37 rows, a ragged K of 2000, uint8
    # input); softmax normalised in the epilogue (N fits one tile) and in
    # a second pass over stored rows (N = 300); every kernel twice on the
    # same input, bit for bit (split-K adds the ranks' partials in rank
    # order, no atomics).
    def repeat_check(label, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        ok = bool(torch.equal(a, b))
        print(f"check {label}: two calls bit-equal | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} repeat")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    conv_model = init_conv_mlp(torch.Generator().manual_seed(0))
    bias_rng = np.random.default_rng(3)
    for layer in conv_model.layers:
        if layer.kind != "maxpool2d":
            layer.biases = bias_rng.normal(0.0, 0.05, layer.biases.shape)
    plan_c, params_c = build_network(conv_model, device=dev)
    tail_at = [i for i, lp in enumerate(plan_c) if lp.kind == "dense"]
    tail = [{"w": params_c[i]["w"], "b": params_c[i]["b"],
             "act": activation_ids([plan_c[i].activation])[0]} for i in tail_at]
    tail_dims = [int(tail[0]["w"].shape[0])] + [int(p["w"].shape[1]) for p in tail]
    tail_acts = [plan_c[i].activation for i in tail_at]
    tail_tag = "-".join(map(str, tail_dims)) + " " + ",".join(tail_acts)
    print(f"plan fused_dense 8192x784->128 on {sms} SMs: (tm, tn) {dense_plan(BATCH, 128, sms)}")
    ld0_, ld1_ = _buffer_widths(tail_dims, activation_ids(tail_acts))
    for tm_, split_ in ((64, 8), (72, 8), (64, 4), (64, 2)):
        n_clusters = max_clusters(torch.cuda.current_device(), tm_, split_,
                                  _chain_smem(tm_, ld0_, ld1_), sms)
        print(f"clusters of {split_} CTAs of {tm_} rows ({tail_tag}) the card runs at once: "
              f"{n_clusters}")
    for label, dims_, acts_, rows in (("784-128-64-10", MNIST, ACTS, BATCH),
                                      (tail_tag, tail_dims, tail_acts, CIFAR_BATCH),
                                      (tail_tag, tail_dims, tail_acts, 37)):
        print(f"plan fcnn_fused_forward {label} x{rows} on {sms} SMs: "
              f"{chain_plan(dims_, activation_ids(acts_), rows, sms, torch.cuda.current_device())}")
    rng_tail = np.random.default_rng(5)
    x_tail = on_card(rng_tail.uniform(0.0, 1.0, (CIFAR_BATCH, tail_dims[0])).astype(np.float32))
    for rows in (CIFAR_BATCH, CIFAR_BATCH - 1, 37):
        e = compare(f"fcnn_fused_forward conv tail {tail_tag} f32 x{rows} (split-K)",
                    fcnn_fused_forward(tail, x_tail[:rows]),
                    fcnn_fused_forward_plain(tail, x_tail[:rows]), 2e-5, 1e-4)
        if rows == CIFAR_BATCH:
            err["fcnn_fused_chain_conv_tail"] = e
    xu8_tail = (x_tail * 255).to(torch.uint8)
    compare(f"fcnn_fused_forward conv tail {tail_tag} uint8 x{CIFAR_BATCH} input_scale=1/255 "
            "(split-K)", fcnn_fused_forward(tail, xu8_tail, input_scale=1.0 / 255.0),
            fcnn_fused_forward_plain(tail, xu8_tail, input_scale=1.0 / 255.0), 2e-5, 1e-4)
    ragged_k = params_from_spec(he_model([2000, 64, 10], ["relu", "softmax"], seed=4), device=dev)
    x_2000 = x_tail[:, :2000].contiguous()
    for rows in (CIFAR_BATCH, 37):
        compare(f"fcnn_fused_forward 2000-64-10 f32 x{rows} (split-K, ragged K)",
                fcnn_fused_forward(ragged_k, x_2000[:rows]),
                fcnn_fused_forward_plain(ragged_k, x_2000[:rows]), 2e-5, 1e-4)
    wide_head = params_from_spec(he_model([784, 128, 300], ["relu", "softmax"], seed=5),
                                 device=dev)
    compare("fcnn_fused_forward 784-128-300 softmax x8191 (softmax past one pass)",
            fcnn_fused_forward(wide_head, x[:8191]), fcnn_fused_forward_plain(wide_head, x[:8191]),
            2e-5, 1e-4)
    h128 = x[:, :128].contiguous()
    w300, b300 = wide_head[1]["w"], wide_head[1]["b"]
    compare("fused_dense 8192x128->300 softmax (second pass)",
            fused_dense(h128, w300, b300, activation="softmax"),
            fused_dense_plain(h128, w300, b300, "softmax"), 1e-5, 1e-5)
    repeat_check("fused_dense 8192x784->128 relu",
                 lambda: fused_dense(x, w1, b1, activation="relu"))
    repeat_check("fcnn_fused_forward 784-128-64-10 x8192", lambda: fcnn_fused_forward(params, x))
    repeat_check(f"fcnn_fused_forward conv tail {tail_tag} x{CIFAR_BATCH} (split-K)",
                 lambda: fcnn_fused_forward(tail, x_tail))
    repeat_check(f"fcnn_fused_forward conv tail {tail_tag} x37 (split-K)",
                 lambda: fcnn_fused_forward(tail, x_tail[:37]))

    # int8 chain: the kernel repeats the plain chain's arithmetic, so relu
    # interiors with a softmax head agree to a few ulps of the softmax
    # (rtol 1e-6, atol 1e-7). A gelu/tanh interior may differ from
    # torch's by an ulp, which can move the next layer's code by one:
    # atol 1e-2 there.
    q = quantize_fcnn(params)
    wide = he_model([1024, 1024, 1024, 10], ACTS, seed=2)
    q_wide = quantize_fcnn(params_from_spec(wide, device=dev))
    x_wide = on_card(rng.uniform(0.0, 1.0, (BATCH, 1024)).astype(np.float32))
    for dims_, rows in ((MNIST, BATCH), (MNIST, 37), ([1024, 1024, 1024, 10], BATCH)):
        print(f"plan fcnn_quantized_forward {'-'.join(map(str, dims_))} x{rows} on {sms} SMs: "
              f"{int8_plan(dims_, rows, sms)}")
    for rows in (BATCH, BATCH - 1, 37):
        e = compare(f"fcnn_quantized_forward 784-128-64-10 x{rows}",
                    fcnn_quantized_forward(q, x[:rows]), forward_quantized(q, x[:rows]),
                    1e-7, 1e-6)
        if rows == BATCH:
            err["int8_chain"] = e
        compare(f"fcnn_quantized_forward 1024-1024-1024-10 x{rows}",
                fcnn_quantized_forward(q_wide, x_wide[:rows]),
                forward_quantized(q_wide, x_wide[:rows]), 1e-7, 1e-6)
    # relu and linear interiors and a linear head: bit for bit.
    q_lin = quantize_fcnn(params_from_spec(he_model(MNIST, ["relu", "linear", "linear"], seed=6),
                                           device=dev))
    for rows in (BATCH, BATCH - 1, 37):
        got_, want_ = fcnn_quantized_forward(q_lin, x[:rows]), forward_quantized(q_lin, x[:rows])
        compare(f"fcnn_quantized_forward 784-128-64-10 relu,linear,linear x{rows} (bit-equal)",
                got_, want_, 0.0, 0.0)
    q_gelu = quantize_fcnn(params_from_spec(
        he_model(MNIST, ["gelu", "tanh", "softmax"], seed=3), device=dev))
    compare("fcnn_quantized_forward 784-128-64-10 gelu,tanh,softmax x8192",
            fcnn_quantized_forward(q_gelu, x), forward_quantized(q_gelu, x), 1e-2, 0.0)
    repeat_check("fcnn_quantized_forward 784-128-64-10 x8192", lambda: fcnn_quantized_forward(q, x))
    repeat_check("fcnn_quantized_forward 784-128-64-10 x37",
                 lambda: fcnn_quantized_forward(q, x[:37]))
    # A 60000-wide input (its codes made 1024 columns at a time) and a
    # 60000-wide interior (cut in two launches by chain_segments).
    for dims_ in ([60000, 16, 10], [64, 60000, 10]):
        q_60k = quantize_fcnn(params_from_spec(he_model(dims_, ["relu", "softmax"], seed=7),
                                               device=dev))
        x_60k = on_card(rng.uniform(0.0, 1.0, (256, dims_[0])).astype(np.float32))
        cut = chain_segments(dims_, activation_ids(["relu", "softmax"]), "int8")
        compare(f"fcnn_quantized_forward {'-'.join(map(str, dims_))} x256 ({len(cut)} launch"
                f"{'es' if len(cut) > 1 else ''})", dense_forward(q_60k, x_60k, quantized=True),
                forward_quantized(q_60k, x_60k), 1e-7, 1e-6)
        del q_60k, x_60k

    # fused_conv2d: the CIFAR conv+MLP network's two conv+pool stages at
    # batch 1024 and a ragged 1023, every activation, and the variants
    # the network does not use (VALID, stride 2, overlapping pool, an
    # even kernel). Direct f32 FFMA vs the plain tap-sum (cuBLAS f32).
    c1, c2 = conv_model.layers[0], conv_model.layers[2]
    cw1, cb1, cw2, cb2 = (on_card(a.astype(np.float32)) for a in (
        c1.weights, c1.biases, c2.weights, c2.biases))
    img1 = on_card(rng.uniform(0.0, 1.0, (CIFAR_BATCH, 32, 32, 3)).astype(np.float32))
    img2 = on_card(rng.uniform(0.0, 1.0, (CIFAR_BATCH, 16, 16, 16)).astype(np.float32))
    pool2 = dict(padding="same", pool_window=(2, 2))

    def conv_check(label, imgs, w, b, **kw):
        return compare(f"fused_conv2d {label}", fused_conv2d(imgs, w, b, **kw),
                       fused_conv2d_plain(imgs, w, b, **kw), *CONV_TOL)

    conv_errs = []
    for rows in (CIFAR_BATCH, CIFAR_BATCH - 1):
        conv_errs.append(conv_check(f"conv1+pool 32x32x3->16 relu x{rows}", img1[:rows],
                                    cw1, cb1, activation="relu", **pool2))
        conv_errs.append(conv_check(f"conv2+pool 16x16x16->32 relu x{rows}", img2[:rows],
                                    cw2, cb2, activation="relu", **pool2))
    for act in ["linear", "sigmoid", "tanh", "gelu", "softmax"]:
        conv_check(f"conv2+pool 16x16x16->32 {act} x{CIFAR_BATCH}", img2, cw2, cb2,
                   activation=act, **pool2)
    conv_check(f"conv1+pool 32x32x3->16 softmax over 16 channels x{CIFAR_BATCH}", img1, cw1,
               cb1, activation="softmax", **pool2)
    conv_check(f"conv2 16x16x16->32 VALID relu, no pool x{CIFAR_BATCH}", img2, cw2, cb2,
               padding="valid", activation="relu")
    conv_check(f"conv1 32x32x3->16 stride 2 SAME relu x{CIFAR_BATCH}", img1, cw1, cb1,
               stride=(2, 2), padding="same", activation="relu")
    conv_check(f"conv1 32x32x3->16 SAME relu + 3x3/2 pool x{CIFAR_BATCH}", img1, cw1, cb1,
               padding="same", activation="relu", pool_window=(3, 3), pool_stride=(2, 2))
    w4 = on_card(rng.normal(0.0, math.sqrt(2.0 / 256), (4, 4, 16, 32)).astype(np.float32))
    conv_check(f"conv 4x4 16x16x16->32 SAME tanh x{CIFAR_BATCH}", img2, w4, cb2,
               padding="same", activation="tanh")
    err["fused_conv2d"] = max(conv_errs)
    for label, shape_, w_shape_, kw_ in (
            ("conv1+pool", (CIFAR_BATCH, 32, 32, 3), (3, 3, 3, 16), pool2),
            ("conv2+pool", (CIFAR_BATCH, 16, 16, 16), (3, 3, 16, 32), pool2)):
        print(f"plan fused_conv2d {label} x{shape_[0]}: {conv_plan(shape_, w_shape_, **kw_)}")
    # Ragged and odd shapes of the implicit GEMM's tiles: an odd 31x29
    # image with overlapping 3x3 stride-2 windows, stride 2 VALID, and the
    # two layers a band planner refused (K streams 16 and 64 input
    # channels a slice), He-scaled weights on uniform pixels.
    img_odd = on_card(rng.uniform(0.0, 1.0, (CIFAR_BATCH - 1, 31, 29, 3)).astype(np.float32))
    conv_check(f"conv1 31x29x3->16 SAME relu + 3x3/2 pool x{CIFAR_BATCH - 1}", img_odd, cw1, cb1,
               padding="same", activation="relu", pool_window=(3, 3), pool_stride=(2, 2))
    conv_check(f"conv2 16x16x16->32 stride 2 VALID relu x{CIFAR_BATCH - 1}",
               img2[:CIFAR_BATCH - 1], cw2, cb2, stride=(2, 2), padding="valid",
               activation="relu")
    for shape_, w_shape_ in (((1, 64, 64, 256), (3, 3, 256, 256)),
                             ((1, 3, 32, 1024), (3, 3, 1024, 1))):
        fan_in = w_shape_[0] * w_shape_[1] * w_shape_[2]
        img_f4 = on_card(rng.uniform(0.0, 1.0, shape_).astype(np.float32))
        w_f4 = on_card(rng.normal(0.0, math.sqrt(2.0 / fan_in), w_shape_).astype(np.float32))
        b_f4 = on_card(rng.normal(0.0, 0.05, w_shape_[3]).astype(np.float32))
        plan_f4 = conv_plan(shape_, w_shape_, padding="same")
        conv_check(f"conv {shape_} x {w_shape_} SAME relu ({plan_f4.slices} K slices of "
                   f"{plan_f4.ck} channels, grid {plan_f4.grid})", img_f4, w_f4, b_f4,
                   padding="same", activation="relu")
    repeat_check(f"fused_conv2d conv2+pool x{CIFAR_BATCH}",
                 lambda: fused_conv2d(img2, cw2, cb2, activation="relu", **pool2))

    # F9: a NaN in some input rows of each kernel whose relu, pool max or
    # int8 row maximum keeps NaN since the repair. The poisoned rows come
    # out non-finite where the plain version's do; every other row is
    # bit-equal to the kernel's output on the clean input and within the
    # check's tolerance of the plain version (bit-equal for the int8
    # chain with relu / linear layers).
    def nan_row_check(label, kernel, plain, clean, atol, rtol, bit_equal=False):
        bad = [3, clean.shape[0] // 2, clean.shape[0] - 1]
        poisoned = clean.clone()
        poisoned.reshape(poisoned.shape[0], -1)[bad, 5] = float("nan")
        got, want, base = kernel(poisoned), plain(poisoned), kernel(clean)
        torch.cuda.synchronize()

        def nonfinite(a):
            return (~torch.isfinite(a.reshape(a.shape[0], -1))).any(dim=1)

        expect = torch.zeros(clean.shape[0], dtype=torch.bool, device=dev)
        expect[bad] = True
        keep = ~expect
        rows_ok = torch.equal(nonfinite(got), expect) and torch.equal(nonfinite(want), expect)
        same = torch.equal(got[keep], base[keep])
        close = bool(torch.allclose(got[keep], want[keep], atol=atol, rtol=rtol))
        if bit_equal:
            close = close and torch.equal(got[keep], want[keep])
        ok = rows_ok and same and close
        print(f"check F9 {label}: NaN in rows {bad}: non-finite rows kernel "
              f"{torch.nonzero(nonfinite(got)).flatten().tolist()}, plain "
              f"{torch.nonzero(nonfinite(want)).flatten().tolist()}; other rows bit-equal to the "
              f"clean input's {same}, {'bit-equal to' if bit_equal else 'within tol of'} the "
              f"plain version {close} | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"F9 {label}")

    nan_row_check("fused_dense 8192x784->128 relu", lambda h: fused_dense(h, w1, b1,
                                                                          activation="relu"),
                  lambda h: fused_dense_plain(h, w1, b1, "relu"), x, 1e-5, 1e-5)
    nan_row_check("fcnn_fused_forward 784-128-64-10 relu,relu,softmax x8192",
                  lambda h: fcnn_fused_forward(params, h),
                  lambda h: fcnn_fused_forward_plain(params, h), x, 2e-5, 1e-4)
    nan_row_check(f"fcnn_fused_forward conv tail {tail_tag} x{CIFAR_BATCH} (split-K)",
                  lambda h: fcnn_fused_forward(tail, h),
                  lambda h: fcnn_fused_forward_plain(tail, h), x_tail, 2e-5, 1e-4)
    nan_row_check("fcnn_quantized_forward 784-128-64-10 relu,relu,softmax x8192",
                  lambda h: fcnn_quantized_forward(q, h), lambda h: forward_quantized(q, h), x,
                  1e-7, 1e-6)
    nan_row_check("fcnn_quantized_forward 784-128-64-10 relu,linear,linear x8192",
                  lambda h: fcnn_quantized_forward(q_lin, h),
                  lambda h: forward_quantized(q_lin, h), x, 0.0, 0.0, bit_equal=True)
    for label, img, cw, cb, kw in (
            ("conv1+pool 32x32x3->16 relu (pool in registers)", img1, cw1, cb1, pool2),
            ("conv2+pool 16x16x16->32 relu (pool in registers)", img2, cw2, cb2, pool2),
            ("conv1 32x32x3->16 SAME relu + 3x3/2 pool (pool from the tile)", img1, cw1, cb1,
             dict(padding="same", pool_window=(3, 3), pool_stride=(2, 2))),
            ("conv2 16x16x16->32 VALID relu, no pool", img2, cw2, cb2, dict(padding="valid"))):
        nan_row_check(f"fused_conv2d {label} x{img.shape[0]}",
                      lambda h, cw=cw, cb=cb, kw=kw: fused_conv2d(h, cw, cb, activation="relu",
                                                                  **kw),
                      lambda h, cw=cw, cb=cb, kw=kw: fused_conv2d_plain(h, cw, cb,
                                                                        activation="relu", **kw),
                      img, *CONV_TOL)

    # Flash attention, both routes, against the plain versions, q, k and
    # v read as the three strided views of one fused projection as the
    # transformer passes them, lse and delta from the plain forward:
    # "f32" calls tdn_flash_fwd_f32 and tdn_flash_bwd_f32 by name
    # (float32); "sm90" goes through the routed
    # flash_fwd / flash_bwd with bf16, which must reach
    # tdn_flash_fwd_sm90 and tdn_flash_bwd_sm90. bf16 kernels against the
    # plain version in float32 on the same bf16 inputs (BF16_RTOL more
    # rtol, and bf16_rounding_bounds); lse is float32 always.
    def flash_inputs(B, T, H, Dh, dtype, seed):
        r = np.random.default_rng(seed)
        qkv = on_card(r.standard_normal((B, T, 3 * H, Dh)).astype(np.float32)).to(dtype)
        do = on_card(r.standard_normal((B, T, H, Dh)).astype(np.float32)).to(dtype)
        return (*qkv.split(H, dim=2), do)

    def compare_bound(label, got, want, bound, atol, rtol):
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        excess = float((diff - (atol + rtol * want.abs() + bound)).max())
        ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and excess <= 0.0
        print(f"check {label}: shape {tuple(got.shape)} max_abs {float(diff.max()):.3e} "
              f"largest share of bound {float((diff / (atol + rtol * want.abs() + bound)).max()):.3f}"
              f" | tol atol {atol:g} rtol {rtol:g} + bf16 rounding bound | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return float(diff.max())

    def flash_check(label, B, T, H, Dh, causal, dtype, route, seed=0):
        q, k, v, do = flash_inputs(B, T, H, Dh, dtype, seed)
        extra = BF16_RTOL if dtype == torch.bfloat16 else 0.0
        (fa, fr), (ga, gr) = FLASH_TOL, FLASH_GRAD_TOL
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        scale = 1.0 / math.sqrt(Dh)
        tag = f"{label} {route} B{B} T{T} H{H} Dh{Dh} " \
              f"{'causal' if causal else 'bidirectional'} {str(dtype).split('.')[-1]}"
        o_ref, lse_ref = flash_fwd_plain(qf, kf, vf, scale=scale, causal=causal)
        delta = (dof * o_ref).sum(-1).transpose(1, 2).contiguous()
        before = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        if route == "f32":
            o, lse = flash_fwd_f32(q, k, v, causal=causal)
            e_fwd = compare(f"flash_fwd_f32 o {tag}", o, o_ref, fa, fr)
            compare(f"flash_fwd_f32 lse {tag}", lse, lse_ref, fa, fr)
            grads = flash_bwd_f32(q, k, v, do, lse_ref, delta, causal=causal)
            refs = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale, causal=causal)
            e_bwd = max(compare(f"flash_bwd_f32 {name} {tag}", g, ref, ga, gr)
                        for name, g, ref in zip(("dq", "dk", "dv"), grads, refs))
            del grads, refs
            want = {"flash_fwd_f32": 1, "flash_bwd_f32": 1}
            errs = (e_fwd, e_bwd)
        else:
            b_o, b_dq, b_dk, b_dv = bf16_rounding_bounds(qf, kf, vf, dof, lse_ref, delta,
                                                         scale=scale, causal=causal)
            o, lse = flash_fwd(q, k, v, causal=causal)
            e_fwd = compare_bound(f"flash_fwd_sm90 o {tag}", o, o_ref, b_o, fa, fr + extra)
            compare(f"flash_fwd_sm90 lse {tag}", lse, lse_ref, fa, fr)
            grads = flash_bwd(q, k, v, do, lse_ref, delta, causal=causal)
            refs = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale, causal=causal)
            rounded = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale,
                                      causal=causal, round_bf16=True)
            e_bwd = 0.0
            for name, g, ref, rref, bound in zip(("dq", "dk", "dv"), grads, refs, rounded,
                                                 (b_dq, b_dk, b_dv)):
                e_bwd = max(e_bwd, compare_bound(f"flash_bwd_sm90 {name} {tag}", g, ref.float(),
                                                 bound, ga, gr + extra))
                print(f"  vs the plain backward with P and dS rounded to bf16: max_abs "
                      f"{float((g.float() - rref.float()).abs().max()):.3e}")
                del ref, rref, bound
            want = {"flash_fwd_sm90": 1, "flash_bwd_sm90": 1}
            errs = (e_fwd, e_bwd)
        ran = {fn.__name__: fn.launches - before[fn.__name__] for fn in KERNEL_WRAPPERS}
        if {k: n for k, n in ran.items() if n} != want:
            print(f"check {tag} route: launches {ran}, expected {want} | FAIL")
            failures.append(f"route {tag}")
        del o_ref
        torch.cuda.empty_cache()
        return errs

    B_LM, H_LM, T_LM, DH_LM = LM["batch"], LM["heads"], LM["seq_len"], LM["d_model"] // LM["heads"]
    err["flash_fwd_f32"], err["flash_bwd_f32"] = flash_check(
        "main shape", B_LM, T_LM, H_LM, DH_LM, True, torch.float32, "f32")
    err["flash_fwd_sm90"], err["flash_bwd_sm90"] = flash_check(
        "main shape", B_LM, T_LM, H_LM, DH_LM, True, torch.bfloat16, "sm90")
    # The model-parallel LM's shape: a microbatch of 4 rows, the 6 heads of
    # a tensor-parallel shard (MP, model 2).
    flash_check("model-parallel shard shape", B_LM // MP["micro"], T_LM, H_LM // MP["model"],
                DH_LM, True, torch.bfloat16, "sm90")
    # Ulysses' local attention: sp alone at seq 4 (3 heads a slot), and
    # pp x tp x sp's microbatch on a model shard's 6 heads over seq 2.
    flash_check("Ulysses shape (sp alone)", B_LM, T_LM, H_LM // SP["seq"], DH_LM, True,
                torch.bfloat16, "sm90")
    flash_check("Ulysses shape (pp x tp x sp)", B_LM // SP["micro"], T_LM,
                H_LM // SP["model"] // SP["pp_seq"], DH_LM, True, torch.bfloat16, "sm90")
    for i, (T, Dh, causal) in enumerate([(1000, 64, False), (40, 64, True), (1000, 32, True),
                                         (40, 32, False), (1000, 128, True), (40, 128, False),
                                         (129, 64, True)]):
        flash_check("ragged", 2, T, 4, Dh, causal, torch.float32, "f32", seed=1 + i)
        flash_check("ragged", 2, T, 4, Dh, causal, torch.bfloat16, "sm90", seed=1 + i)
    # Each backward twice on one input, at the 85M shape and at Dh 32 and
    # 128: dq, dk and dv bit-equal (the kernels sum dq in key-block order).
    for Dh in (DH_LM, 32, 128):
        for route, dtype, kern in (("f32", torch.float32, flash_bwd_f32),
                                   ("sm90", torch.bfloat16, flash_bwd_sm90)):
            rq, rk, rv, rdo = flash_inputs(B_LM, T_LM, H_LM, Dh, dtype, seed=Dh)
            r_o, r_lse = flash_fwd_plain(rq.float(), rk.float(), rv.float(),
                                         scale=1.0 / math.sqrt(Dh), causal=True)
            r_delta = (rdo.float() * r_o).sum(-1).transpose(1, 2).contiguous()
            del r_o
            first = kern(rq, rk, rv, rdo, r_lse, r_delta, causal=True)
            second = kern(rq, rk, rv, rdo, r_lse, r_delta, causal=True)
            torch.cuda.synchronize()
            differ = [int((a != b).sum()) for a, b in zip(first, second)]
            ok = not any(differ)
            print(f"check flash_bwd_{route} twice on one input, B{B_LM} T{T_LM} H{H_LM} Dh{Dh} "
                  f"causal: not-bit-equal dq, dk, dv {differ} | bit-equal | "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_bwd_{route} repeat Dh{Dh}")
            del rq, rk, rv, rdo, r_lse, r_delta, first, second
            torch.cuda.empty_cache()
    DH_RC = RECIPE["d_model"] // RECIPE["heads"]
    flash_check("recipe shape", RECIPE["batch"], RECIPE["seq_len"], RECIPE["heads"], DH_RC,
                True, torch.float32, "f32")
    if failures:
        fail(f"kernel checks failed: {failures}")

    # ------------------------------------------------------ 3. main path
    mark("dense main path")
    data = rng.uniform(0.0, 1.0, (ROWS, MNIST[0])).astype(np.float32)
    out_dir = ROOT / ".chip_smoke"  # scratch inside the checkout (.gitignore lists it)
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        model_path = Path(tmp) / "mnist_fcnn.json"
        save_model(model, model_path)

        reset_launch_counts()
        eng = Engine.up(model_path, [1, 1, 1])
        res32 = eng.run_inference(data, batch_size=BATCH)
        engq = Engine.up(model_path, [1, 1, 1], quantize="int8")
        before = fcnn_quantized_forward.launches
        resq = engq.run_inference(data, batch_size=BATCH)
        int8_batch_launches = fcnn_quantized_forward.launches - before

        labels = res32.outputs[:256].argmax(-1)
        examples = Path(tmp) / "examples_256.json"
        save_examples(data[:256], labels, examples)
        cli = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config",
             str(model_path), "--inputs", str(examples), "--batch-size", "64",
             "--quantize", "int8"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        doctor_rc = cli_main(["doctor"])
        launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    print(f"main path launches: {json.dumps(launches)}")
    print(f"cli infer --quantize int8 (rc {cli.returncode}):")
    for line in cli.stdout.strip().splitlines():
        print(f"  {line}")
    if cli.returncode != 0:
        fail(f"cli infer exited {cli.returncode}: {cli.stderr[-2000:]}")
    if "Correct predictions" not in cli.stdout:
        fail("cli infer printed no accuracy line")
    if doctor_rc != 0:
        fail(f"cli doctor exited {doctor_rc}")
    missing = [k for k in DENSE_PATH_KERNELS if launches[k] < 1]
    if missing:
        fail(f"kernels never launched on the dense main path: {missing}")
    n_batches = math.ceil(ROWS / BATCH)
    print(f"int8 run_inference: kernel launches {int8_batch_launches} for {n_batches} batches")
    if int8_batch_launches != n_batches:
        fail("the int8 engine run did not go through the int8 kernel once per batch")

    for label, res in (("f32", res32), ("int8", resq)):
        if res.outputs.shape != (ROWS, MNIST[-1]) or not np.isfinite(res.outputs).all():
            fail(f"{label} engine outputs: shape {res.outputs.shape} or non-finite values")
    want = oracle_forward_batch(model, data[:2048])
    o_err = float(np.abs(res32.outputs[:2048] - want).max())
    print(f"check engine f32 vs float64 oracle (2048 rows): max_abs {o_err:.3e} | tol atol 1e-05"
          f" | {'ok' if o_err <= 1e-5 else 'FAIL'}")
    if o_err > 1e-5:
        fail("f32 engine outputs disagree with the float64 oracle")
    compare("engine int8 vs plain forward_quantized (60000 rows)",
            torch.from_numpy(resq.outputs), forward_quantized(q, on_card(data)).cpu(),
            1e-7, 1e-6)
    if failures:
        fail(f"main-path checks failed: {failures}")
    agree = float((resq.outputs.argmax(-1) == res32.outputs.argmax(-1)).mean())
    print(f"int8 vs f32 argmax agreement: {agree:.4f}")

    # uint8 rows through the dense f32 engine reach the chain kernel as
    # they are (scale 1): bit-equal to the same rows cast to float32.
    rows_u8 = rng.integers(0, 256, (BATCH, MNIST[0])).astype(np.uint8)
    for n_u8 in (BATCH, 37):
        reset_launch_counts()
        got_u8 = eng.infer(rows_u8[:n_u8])
        u8_launches = fcnn_fused_forward.launches
        want_u8 = eng.infer(rows_u8[:n_u8].astype(np.float32))
        ok = u8_launches == 1 and np.array_equal(got_u8, want_u8)
        print(f"check engine f32 uint8 rows x{n_u8} vs the rows cast to float32: not-bit-equal "
              f"{int((got_u8 != want_u8).sum())}, chain launches {u8_launches} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("uint8 rows through the dense engine differ from the float32 rows")

    # ------------------------------------------ the layer pipeline path
    mark("pipeline_phase")
    pipeline_phase(dev, model, data, resq, he_model, out_dir, smi[0], failures)

    # ------------------------------------------------- the train path
    mark("train_phase")
    train_phase(dev, model, data, out_dir, smi[0], compare, failures)

    # ------------------------------------------------ the Process path
    mark("process_phase")
    process_phase(dev, model, conv_model, data, rng, params, q, out_dir, smi[0], compare,
                  failures)
    guard_phase(dev, model, data, out_dir, smi[0])

    # --------------------------------------------- the conv train path
    mark("conv_train_phase")
    conv_train_phase(dev, out_dir, smi[0], compare, failures)

    # Dense runs past one chain launch: deeper than 32 layers or wider
    # than a chain's shared memory holds. chain_segments cuts each; every
    # engine's counts are zeroed before its run (4 batches) and read after.
    for label, dims_, quant, n_seg in (("34-layer 16-wide f32", [16] * 35, None, 2),
                                       ("34-layer 16-wide int8", [16] * 35, "int8", 2),
                                       ("784-4000-10 f32", [784, 4000, 10], None, 2),
                                       ("64-8192-10 f32", [64, 8192, 10], None, 2),
                                       ("60000-16-10 int8", [60000, 16, 10], "int8", 1),
                                       ("64-60000-10 int8", [64, 60000, 10], "int8", 2)):
        acts_ = ["relu"] * (len(dims_) - 2) + ["softmax"]
        model_ = he_model(dims_, acts_, seed=len(dims_) + dims_[1])
        rows_ = 256 if dims_[0] > 10000 else 2048
        data_ = rng.uniform(0.0, 1.0, (rows_, dims_[0])).astype(np.float32)
        eng_ = Engine.up(model_, quantize=quant)
        reset_launch_counts()
        res_ = eng_.run_inference(data_, batch_size=rows_ // 4)
        counts_ = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        cut = chain_segments(dims_, activation_ids(acts_), quant or "float32")
        chain_key = "fcnn_quantized_forward" if quant else "fcnn_fused_forward"
        print(f"engine past one chain, {label}: cut {[tuple(sg) for sg in cut]}; launches over 4 "
              f"batches {json.dumps({k: n for k, n in counts_.items() if n})}: "
              f"{counts_[chain_key] / 4:g} chain launches a batch")
        if (len(cut) != n_seg or counts_[chain_key] != 4 * sum(not sg.dense for sg in cut)
                or counts_["fused_dense"] != 4 * sum(sg.dense for sg in cut)):
            fail(f"the {label} engine did not launch one kernel per segment per batch")
        if quant:
            q_ = quantize_fcnn(params_from_spec(model_, device=dev))
            compare(f"engine {label} vs plain forward_quantized ({rows_} rows)",
                    torch.from_numpy(res_.outputs), forward_quantized(q_, on_card(data_)).cpu(),
                    1e-7, 1e-6)
        else:
            # The per-row oracle forwards one row at a time (the
            # reference's loop): too slow for thousands of neurons, so a
            # wide model's rows are held against its arithmetic batched
            # in float64 (dense_f64), itself held to the per-row oracle
            # on 16 rows.
            wide = max(dims_) > 1000
            want_ = dense_f64(model_, data_) if wide else oracle_forward_batch(model_, data_)
            o_err = float(np.abs(res_.outputs - want_).max())
            ref_err = (float(np.abs(want_[:16] - oracle_forward_batch(model_, data_[:16])).max())
                       if wide else 0.0)
            ok_ = o_err <= 1e-5 and ref_err <= 1e-10
            how = (f"batched; it is {ref_err:.3e} from the per-row oracle on 16 rows, tol 1e-10"
                   if wide else "per row")
            print(f"check engine {label} vs float64 oracle (all {rows_} rows, {how}): "
                  f"max_abs {o_err:.3e} | tol atol 1e-05 | {'ok' if ok_ else 'FAIL'}")
            if not ok_:
                failures.append(f"engine {label}")
        del eng_, res_, data_
    if failures:
        fail(f"engines past one chain failed: {failures}")

    mark("conv main path")
    # The conv path: the CIFAR-10 conv+MLP network, each conv with its
    # pool in one fused_conv2d launch and the dense tail in one chain
    # launch per batch.
    data_c = rng.uniform(0.0, 1.0, (CIFAR_ROWS, conv_model.input_dim)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        conv_path = Path(tmp) / "cifar_conv_mlp.json"
        save_model(conv_model, conv_path)

        reset_launch_counts()
        engc = Engine.up(conv_path, [2, 2, 2])
        before = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        resc = engc.run_inference(data_c, batch_size=CIFAR_BATCH)
        run_launches = {fn.__name__: fn.launches - before[fn.__name__]
                        for fn in KERNEL_WRAPPERS}
        examples_c = Path(tmp) / "cifar_examples_256.json"
        save_examples(data_c[:256], resc.outputs[:256].argmax(-1), examples_c)
        cli_c = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config",
             str(conv_path), "--inputs", str(examples_c), "--batch-size", "64"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        conv_launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    c_batches = math.ceil(CIFAR_ROWS / CIFAR_BATCH)
    print(f"conv main path launches: {json.dumps(conv_launches)}")
    print(f"conv run_inference over {CIFAR_ROWS} rows at batch {CIFAR_BATCH} ({c_batches} "
          f"batches): launches {json.dumps(run_launches)}")
    print(f"cli infer conv model (rc {cli_c.returncode}):")
    for line in cli_c.stdout.strip().splitlines():
        print(f"  {line}")
    if cli_c.returncode != 0:
        fail(f"cli infer on the conv model exited {cli_c.returncode}: {cli_c.stderr[-2000:]}")
    if "Correct predictions" not in cli_c.stdout:
        fail("cli infer on the conv model printed no accuracy line")
    missing = [k for k in CONV_PATH_KERNELS if conv_launches[k] < 1]
    if missing:
        fail(f"kernels never launched on the conv main path: {missing}")
    if (run_launches["fused_conv2d"] != 2 * c_batches
            or run_launches["fcnn_fused_forward"] != c_batches):
        fail("the conv engine run did not launch fused_conv2d twice and the chain kernel "
             "once per batch")
    if resc.outputs.shape != (CIFAR_ROWS, 10) or not np.isfinite(resc.outputs).all():
        fail(f"conv engine outputs: shape {resc.outputs.shape} or non-finite values")
    # 128 rows spread over every batch of the run, the ragged last one
    # and the run's last row included.
    picked = np.linspace(0, CIFAR_ROWS - 1, 128).round().astype(int)
    want = oracle_forward_batch(conv_model, data_c[picked])
    c_err = float(np.abs(resc.outputs[picked] - want).max())
    print(f"check conv engine vs float64 oracle (128 rows across all {c_batches} batches): "
          f"max_abs {c_err:.3e} | tol atol 1e-05 | {'ok' if c_err <= 1e-5 else 'FAIL'}")
    if c_err > 1e-5:
        fail("conv engine outputs disagree with the float64 oracle")

    mark("LM main path")
    # The LM training path. The corpus is read, tokenised and split as
    # the CLI does it (95/5), before the counts are zeroed.
    text, source = load_corpus()
    rows = lm_sequences(encode(text), LM["seq_len"])
    split = max(1, int(len(rows) * 0.95))
    train_rows, eval_rows = rows[:split], rows[split:]
    print(f"corpus {source}: {len(text)} bytes, {len(train_rows)} train and {len(eval_rows)} "
          f"held-out rows of {LM['seq_len'] + 1} tokens")

    def lm_config(layers, dtype, remat):
        return TransformerConfig(vocab_size=256, d_model=LM["d_model"], n_heads=LM["heads"],
                                 n_layers=layers, d_ff=4 * LM["d_model"],
                                 max_seq_len=LM["seq_len"], compute_dtype=dtype, remat=remat)

    # Training parity at full width, depth 2, float32, batch 4: the flash
    # kernels against the materialised dot_product_attention, both passed
    # explicitly, from the same weights and batches.
    cfg2 = lm_config(2, "float32", False)
    params2 = init_transformer(torch.Generator().manual_seed(1), cfg2, device=dev)
    stream = lm_batches(train_rows, 4, seed=1, epochs=None)
    batches2 = [next(stream) for _ in range(3)]
    tokens2 = torch.from_numpy(batches2[0]).to(dev)
    grads = {}
    for label, attn in (("flash", flash_attention), ("dot_product", dot_product_attention)):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params2)
        loss = lm_loss(p, tokens2, cfg2, attn)
        grads[label] = (float(loss.detach()), torch.autograd.grad(loss, param_leaves(p)))
    print(f"parity first-step loss: flash {grads['flash'][0]!r} dot_product "
          f"{grads['dot_product'][0]!r}")
    g_err = max(float((a - b).abs().max())
                for a, b in zip(grads["flash"][1], grads["dot_product"][1]))
    g_ok = all(torch.allclose(a, b, atol=5e-4, rtol=5e-4)
               for a, b in zip(grads["flash"][1], grads["dot_product"][1]))
    print(f"check parity first-step gradients ({len(grads['flash'][1])} leaves): max_abs "
          f"{g_err:.3e} | tol atol 5e-4 rtol 5e-4 | {'ok' if g_ok else 'FAIL'}")
    del grads
    train_cfg2 = LMTrainConfig(learning_rate=LM["lr"], steps=3, batch_size=4,
                               seq_len=LM["seq_len"], log_every=1)

    def parity_steps(cfg_p, params_p):
        """3 steps with the flash kernels (their launches counted alone:
        the route's own path) and 3 with dot_product_attention."""
        reset_launch_counts()
        hist_flash = train_lm(params_p, cfg_p, batches2, train_cfg2, attn_fn=flash_attention)[1]
        counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        hist_ref = train_lm(params_p, cfg_p, batches2, train_cfg2,
                            attn_fn=dot_product_attention)[1]
        return (np.array([h["loss"] for h in hist_flash]),
                np.array([h["loss"] for h in hist_ref]), counts)

    l_flash, l_ref, f32_launches = parity_steps(cfg2, params2)
    rel = np.abs(l_flash - l_ref) / np.abs(l_ref)
    p_ok = len(l_flash) == 3 and rel[0] <= 1e-5 and rel.max() <= 1e-4
    print(f"check parity 3 float32 steps (768/12 heads, depth 2, T 1024, batch 4): flash "
          f"{l_flash.tolist()} vs dot_product {l_ref.tolist()}, rel {rel.tolist()} | tol "
          f"first 1e-5, all 1e-4 | {'ok' if p_ok else 'FAIL'}")
    # The float32 LM twin: 2 layers x 3 steps, no remat, on the f32 kernels.
    want_f32 = {"flash_fwd_f32": 6, "flash_bwd_f32": 6}
    print(f"float32 LM twin launches: {json.dumps(f32_launches)}; expected {json.dumps(want_f32)}"
          " and no sm90 launch")
    f32_route_ok = (all(f32_launches[k] == n for k, n in want_f32.items())
                    and f32_launches["flash_fwd_sm90"] == f32_launches["flash_bwd_sm90"] == 0)
    if not (g_ok and p_ok and f32_route_ok):
        fail("float32 training with the flash kernels disagrees with dot_product_attention "
             "or did not take the f32 kernels")
    del params2

    # The same in bf16 (the LM path's dtype), on the sm90 kernels.
    cfg2b = lm_config(2, "bfloat16", False)
    params2b = init_transformer(torch.Generator().manual_seed(1), cfg2b, device=dev)
    l_flash, l_ref, bf16_launches = parity_steps(cfg2b, params2b)
    rel = np.abs(l_flash - l_ref) / np.abs(l_ref)
    first_tol, all_tol = BF16_PARITY_RTOL
    pb_ok = (len(l_flash) == 3 and np.isfinite(l_flash).all() and rel[0] <= first_tol
             and rel.max() <= all_tol and bf16_launches["flash_fwd_sm90"] == 6
             and bf16_launches["flash_bwd_sm90"] == 6
             and bf16_launches["flash_fwd_f32"] == bf16_launches["flash_bwd_f32"] == 0)
    print(f"check parity 3 bf16 steps (768/12 heads, depth 2, T 1024, batch 4): sm90 flash "
          f"{l_flash.tolist()} vs dot_product {l_ref.tolist()}, rel {rel.tolist()} | tol "
          f"first {first_tol:g}, all {all_tol:g}; launches {json.dumps(bf16_launches)} | "
          f"{'ok' if pb_ok else 'FAIL'}")
    if not pb_ok:
        fail("bf16 training with the sm90 flash kernels disagrees with dot_product_attention")
    del params2b
    torch.cuda.empty_cache()

    # The main path: the 85M recipe through train_lm and evaluate_lm.
    cfg = lm_config(LM["layers"], "bfloat16", True)
    lm_params = init_transformer(torch.Generator().manual_seed(0), cfg, device=dev)
    n_params = num_params(lm_params)
    train_cfg = LMTrainConfig(learning_rate=LM["lr"], steps=LM["steps"],
                              batch_size=LM["batch"], seq_len=LM["seq_len"], log_every=1,
                              warmup_steps=LM["warmup"], lr_schedule="cosine")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lm_params, history = train_lm(lm_params, cfg,
                                  lm_batches(train_rows, LM["batch"], seed=0, epochs=None),
                                  train_cfg)
    lm_eval = evaluate_lm(lm_params, cfg, eval_rows, batch_size=LM["batch"],
                          max_batches=LM["eval_batches"])
    lm_launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"LM parameters: {n_params:,} (record: {LM['params']:,})")
    for h in history:
        print(f"  LM step {h['step']}: loss {h['loss']!r} at {h['seconds']:.4f} s")
    losses = [h["loss"] for h in history]
    lm_steady = (history[-1]["seconds"] - history[4]["seconds"]) / (len(history) - 5)
    tokens_per_step = LM["batch"] * LM["seq_len"]
    print(f"LM steady (steps 6-{len(history)}): {lm_steady:.4f} s/step, "
          f"{tokens_per_step / lm_steady:.1f} tokens/s; steps 1-5 (warm-up) took "
          f"{history[4]['seconds']:.3f} s")
    print(f"LM held-out ({lm_eval['eval_rows_used']} rows): loss "
          f"{lm_eval['loss_nats_per_token']!r} nats/token, perplexity "
          f"{lm_eval['perplexity']!r}, {float(lm_eval['bits_per_byte'])!r} bits/byte")
    print(f"LM peak CUDA memory: {peak_gb:.3f} GB")
    want_launches = {
        "flash_fwd_sm90": LM["steps"] * LM["layers"] * 2 + LM["layers"] * LM["eval_batches"],
        "flash_bwd_sm90": LM["steps"] * LM["layers"],
        "flash_fwd_f32": 0, "flash_bwd_f32": 0,
    }
    print(f"LM main path launches: {json.dumps(lm_launches)}; expected {json.dumps(want_launches)}")
    if n_params != LM["params"]:
        fail(f"the LM has {n_params} parameters, not {LM['params']}")
    if len(losses) != LM["steps"] or not all(math.isfinite(x) for x in losses):
        fail(f"LM losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the LM's last loss {losses[-1]} is not below its first {losses[0]}")
    if not math.isfinite(lm_eval["loss_nats_per_token"]):
        fail(f"LM held-out loss {lm_eval['loss_nats_per_token']}")
    if any(lm_launches[k] != v for k, v in want_launches.items()):
        fail("the LM main path did not launch the flash kernels the expected number of times")
    torch.cuda.empty_cache()
    # The same recipe's step eager (8 steps) and as 4-step supersteps
    # (the first 16 of its 30 steps), from the same init and batches.
    fresh = init_transformer(torch.Generator().manual_seed(0), cfg, device=dev)
    stream = lm_batches(train_rows, LM["batch"], seed=0, epochs=None)
    lm_k_arms(cfg, fresh, [next(stream) for _ in range(16)], train_cfg, 4, 8, losses,
              "LM 85M bf16 step (graphed K=1: the steady line above)", smi[0])
    del fresh
    torch.cuda.empty_cache()
    # Generation from the trained params.
    mark("generate_phase")
    generate_phase(dev, cfg, lm_params, eval_rows, out_dir, smi[0], (mem_rate, bf16_rate))
    mark("serving_phase")
    serving_phase(dev, cfg, eval_rows, out_dir, smi[0])
    del lm_params
    torch.cuda.empty_cache()
    mark("model_parallel_phase")
    model_parallel_phase(dev, cfg, train_rows, eval_rows, out_dir, smi[0])
    torch.cuda.empty_cache()
    mark("seq_parallel_phase")
    seq_parallel_phase(dev, cfg, text, out_dir, smi[0])
    torch.cuda.empty_cache()
    mark("moe_phase")
    moe_phase(dev, cfg, text, out_dir, smi[0])
    torch.cuda.empty_cache()
    mark("data_parallel_phase")
    data_parallel_phase(dev, model, conv_model, data, data_c, cfg, text, train_rows, out_dir,
                        smi[0], compare)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        metrics = Path(tmp) / "lm_metrics.jsonl"
        cli_lm = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "lm", "--d-model", "768",
             "--heads", "12", "--layers", "2", "--seq-len", "1024", "--steps", "4",
             "--batch-size", "4", "--bf16", "--remat", "--lr", "3e-4", "--lr-schedule",
             "cosine", "--warmup-steps", "1", "--eval-batches", "2", "--log-every", "2",
             "--steps-per-call", "2", "--metrics-out", str(metrics)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        n_metrics = len(metrics.read_text().splitlines()) if metrics.is_file() else 0
    print(f"cli lm (rc {cli_lm.returncode}): {cli_lm.stdout.strip()}")
    if cli_lm.returncode != 0:
        fail(f"cli lm exited {cli_lm.returncode}: {cli_lm.stderr[-2000:]}")
    report = json.loads(cli_lm.stdout.strip().splitlines()[-1])
    keys = {"train_seconds", "final_train_loss", "eval_split", "loss_nats_per_token",
            "perplexity", "bits_per_byte", "eval_rows_used"}
    # --steps-per-call 2 --log-every 2: the begin record, steps 2 and 4, the report
    if set(report) != keys or report["eval_split"] != "held-out" or n_metrics != 4:
        fail(f"cli lm report keys {sorted(report)} or {n_metrics} metrics lines (want 4)")

    mark("float32 LM main path")
    # The float32 LM main path: tdn lm's default recipe, as cmd_lm runs it
    # (corpus split 95/5, weights from the seed, batches from the seed,
    # the whole held-out split in full batches), each step stamped after
    # its loss sync (log_every 1; cmd_lm's default logs every 50th, which
    # changes no number).
    text_rc, source_rc = load_corpus(ROOT / RECIPE["corpus"])
    rows_rc = lm_sequences(encode(text_rc), RECIPE["seq_len"])
    split_rc = max(1, int(len(rows_rc) * 0.95))
    train_rc, eval_rc = rows_rc[:split_rc], rows_rc[split_rc:]
    cfg_rc = TransformerConfig(vocab_size=256, d_model=RECIPE["d_model"],
                               n_heads=RECIPE["heads"], n_layers=RECIPE["layers"],
                               d_ff=4 * RECIPE["d_model"], max_seq_len=RECIPE["seq_len"])
    params_rc = init_transformer(torch.Generator().manual_seed(RECIPE["seed"]), cfg_rc,
                                 device=dev)
    train_cfg_rc = LMTrainConfig(learning_rate=RECIPE["lr"], steps=RECIPE["steps"],
                                 batch_size=RECIPE["batch"], seq_len=RECIPE["seq_len"],
                                 warmup_steps=RECIPE["warmup"], lr_schedule="cosine",
                                 log_every=1)
    print(f"recipe corpus {source_rc}: {len(text_rc)} bytes, {len(train_rc)} train and "
          f"{len(eval_rc)} held-out rows of {RECIPE['seq_len'] + 1} tokens; "
          f"{num_params(params_rc):,} parameters, float32")
    torch.cuda.synchronize()
    reset_launch_counts()
    params_rc, hist_rc = train_lm(
        params_rc, cfg_rc, lm_batches(train_rc, RECIPE["batch"], seed=RECIPE["seed"], epochs=None),
        train_cfg_rc)
    eval_rc_m = evaluate_lm(params_rc, cfg_rc, eval_rc, batch_size=RECIPE["batch"])
    rc_launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    losses_rc = [h["loss"] for h in hist_rc]
    for h in hist_rc:
        if h["step"] in (1, 2, 3) or h["step"] % 50 == 0:
            print(f"  recipe step {h['step']}: loss {h['loss']!r} at {h['seconds']:.4f} s")
    warm = RECIPE["warmup"]
    rc_steady = (hist_rc[-1]["seconds"] - hist_rc[warm - 1]["seconds"]) / (len(hist_rc) - warm)
    print(f"recipe steady (steps {warm + 1}-{len(hist_rc)}): {rc_steady:.6f} s/step, "
          f"{RECIPE['batch'] * RECIPE['seq_len'] / rc_steady:.1f} tokens/s; steps 1-{warm} took "
          f"{hist_rc[warm - 1]['seconds']:.3f} s")
    rc_loss = eval_rc_m["loss_nats_per_token"]
    print(f"recipe held-out ({eval_rc_m['eval_rows_used']} rows): loss {rc_loss!r} nats/token, "
          f"perplexity {eval_rc_m['perplexity']!r}, {float(eval_rc_m['bits_per_byte'])!r} "
          f"bits/byte; record {RECIPE['loss']} / {RECIPE['perplexity']} / "
          f"{RECIPE['bits_per_byte']} (TPU twin perplexity 12.5648)")
    rc_batches = eval_rc_m["eval_rows_used"] // RECIPE["batch"]
    want_rc = {"flash_fwd_f32": RECIPE["steps"] * RECIPE["layers"] + rc_batches * RECIPE["layers"],
               "flash_bwd_f32": RECIPE["steps"] * RECIPE["layers"],
               "flash_fwd_sm90": 0, "flash_bwd_sm90": 0}
    print(f"recipe path launches: {json.dumps(rc_launches)}; expected {json.dumps(want_rc)}")
    if len(losses_rc) != RECIPE["steps"] or not all(math.isfinite(x) for x in losses_rc):
        fail(f"recipe losses not finite or not {RECIPE['steps']} of them")
    if not losses_rc[-1] < losses_rc[0]:
        fail(f"the recipe's last loss {losses_rc[-1]} is not below its first {losses_rc[0]}")
    if not (math.isfinite(rc_loss) and abs(rc_loss - RECIPE["loss"]) <= RECIPE["band"]):
        fail(f"recipe held-out loss {rc_loss} is not within {RECIPE['band']} nats of "
             f"{RECIPE['loss']}")
    if any(rc_launches[k] != n for k, n in want_rc.items()):
        fail("the float32 recipe did not go through the f32 flash kernels only")
    del params_rc
    # The recipe's step eager (100 steps) and as 8-step supersteps (all
    # 400 steps), from the same init and batches.
    params_rc = init_transformer(torch.Generator().manual_seed(RECIPE["seed"]), cfg_rc,
                                 device=dev)
    stream = lm_batches(train_rc, RECIPE["batch"], seed=RECIPE["seed"], epochs=None)
    lm_k_arms(cfg_rc, params_rc, [next(stream) for _ in range(RECIPE["steps"])], train_cfg_rc,
              RECIPE_K, 100, losses_rc, "float32 recipe step (graphed K=1: the steady line "
              "above)", smi[0])
    del params_rc

    mark("card's numbers")
    # ----------------------------------------------- 4. card's numbers
    # The main-path run above is each engine's first pass over the data
    # (it also fills PyTorch's pinned-memory cache); three more passes
    # give the steady state.
    for label, e, first, rows_in, bs in (("f32", eng, res32, data, BATCH),
                                         ("int8", engq, resq, data, BATCH),
                                         ("conv", engc, resc, data_c, CIFAR_BATCH)):
        n = len(rows_in)
        runs = [first] + [e.run_inference(rows_in, batch_size=bs) for _ in range(3)]
        for i, res in enumerate(runs):
            lat = res.latency_summary()
            print(f"engine {label} pass {i}: {n / res.seconds:.1f} samples/s over {n} "
                  f"rows at batch {bs}; batch latency p50 {lat['p50_s'] * 1e3:.3f} ms "
                  f"p90 {lat['p90_s'] * 1e3:.3f} ms max {lat['max_s'] * 1e3:.3f} ms "
                  f"(n={lat['count']})")
        steady = LatencyStats("steady", [t for r in runs[1:] for t in r.batch_seconds])
        print(f"engine {label}: setup {e.setup_seconds:.3f} s; steady (passes 1-3) median "
              f"{float(np.median([n / r.seconds for r in runs[1:]])):.1f} samples/s, batch "
              f"p50 {steady.percentile(50) * 1e3:.3f} ms p90 {steady.percentile(90) * 1e3:.3f} "
              f"ms (n={len(steady)})")

    # One batch's stages, each timed alone: the host cast into pinned
    # memory (host clock), the copy to the card, the forward on the card
    # (dense: one chain launch; conv: conv1+pool, conv2+pool and the
    # 2048-64-10 chain), the copy back.
    for label, host_rows, forward in (
            ("dense f32", data[:BATCH], lambda h: fcnn_fused_forward(params, h)),
            ("conv", data_c[:CIFAR_BATCH], lambda h: network_forward(plan_c, params_c, h))):
        staged = torch.empty(host_rows.shape, dtype=torch.float32, pin_memory=True)
        t0 = time.perf_counter()
        for _ in range(10):
            staged.copy_(torch.from_numpy(host_rows))
        cast_ms = (time.perf_counter() - t0) / 10 * 1e3
        h2d_ms = cuda_time_ms(lambda: staged.to(dev, non_blocking=True), iters=20)
        batch = staged.to(dev)
        fwd_ms = cuda_time_ms(lambda: forward(batch), iters=20)
        fwd_dev_ms = cuda_graph_time_ms(lambda: forward(batch), iters=20)
        out_dev = forward(batch)
        back = torch.empty(out_dev.shape, dtype=torch.float32, pin_memory=True)
        d2h_ms = cuda_time_ms(lambda: back.copy_(out_dev, non_blocking=True), iters=20)
        print(f"engine {label} batch stages @ {len(host_rows)} rows: host cast to pinned "
              f"{cast_ms:.3f} ms, host-to-device {h2d_ms:.3f} ms "
              f"({host_rows.nbytes / h2d_ms / 1e6:.1f} GB/s), forward {fwd_ms:.4f} ms "
              f"(device time, CUDA graph: {fwd_dev_ms:.4f} ms), "
              f"device-to-host {d2h_ms:.4f} ms")
    tail_in = network_forward(plan_c[:4], params_c[:4], batch)
    tail_ms = cuda_time_ms(lambda: network_forward(plan_c[4:], params_c[4:], tail_in), iters=20)
    tail_dev_ms = cuda_graph_time_ms(lambda: network_forward(plan_c[4:], params_c[4:], tail_in),
                                     iters=20)
    print(f"engine conv batch stages @ {CIFAR_BATCH} rows: of the forward, the 2048-64-10 "
          f"dense chain {tail_ms:.4f} ms (device time, CUDA graph: {tail_dev_ms:.4f} ms)")

    # Four distinct inputs (4 x 25.7 MB > the 50 MB L2), cycled, so each
    # launch reads x from device memory as a freshly copied batch would.
    xs = [x] + [on_card(rng.uniform(0.0, 1.0, (BATCH, MNIST[0])).astype(np.float32))
                for _ in range(3)]

    def cycled(fn, inputs=xs):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % len(inputs)
            return fn(inputs[state["i"]])
        return call

    def loop_or_graph(fn):
        """The device time of a call: a host loop of 50 calls, or, where
        that loop takes over 10% longer than 50 calls captured in one CUDA
        graph (the host then sets its pace), the graph's. Returns the
        timer chosen and both times."""
        loop, graph = cuda_time_ms(fn), cuda_graph_time_ms(fn)
        if loop > 1.1 * graph:
            return cuda_graph_time_ms, loop, graph
        return cuda_time_ms, loop, graph

    def addmm_chain(h):
        for p, act in zip(params, ACTS):
            h = apply_activation(torch.addmm(p["b"], h, p["w"]), act)
        return h

    def int_mm_chain(h):
        # torch._int_mm needs N % 8 == 0: the 10-wide head runs as 16
        # columns (zero weights) and is sliced back.
        for p, wq, act in int_mm_layers:
            absmax = torch.clamp_min(h.abs().amax(dim=-1, keepdim=True), 1e-8)
            s = absmax / torch.full_like(absmax, 127.0)
            hq = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
            z = torch._int_mm(hq, wq)[:, : p["wq"].shape[1]]
            h = apply_activation(z.to(torch.float32) * (s * p["scale"][None, :]) + p["b"], act)
        return h

    int_mm_layers = []
    for p, act in zip(q, ACTS):
        n = p["wq"].shape[1]
        wq = torch.zeros((p["wq"].shape[0], -(-n // 8) * 8), dtype=torch.int8, device=dev)
        wq[:, :n] = p["wq"]
        int_mm_layers.append((p, wq, act))
    try:
        int_mm_chain(x)
        int_mm_ok = True
    except RuntimeError as e:
        print(f"torch._int_mm unavailable here ({e}); int8 library_ms is null")
        int_mm_ok = False

    M, (d0, d1, d2, d3) = BATCH, MNIST
    flops_chain = 2.0 * M * (d0 * d1 + d1 * d2 + d2 * d3)
    w_f32 = 4 * sum(a * b + b for a, b in zip(MNIST[:-1], MNIST[1:]))
    w_i8 = sum(a * b + 8 * b for a, b in zip(MNIST[:-1], MNIST[1:]))
    specs = [
        ("fused_dense", "tpu_dist_nn_torch/kernels/csrc/fused_dense.cu",
         "tpu_dist_nn/kernels/fused_dense.py:75",
         lambda h: fused_dense(h, w1, b1, activation="relu"),
         lambda h: fused_dense_plain(h, w1, b1, "relu"),
         lambda h: torch.relu(torch.addmm(b1, h, w1)),
         4.0 * (M * d0 + d0 * d1 + d1 + M * d1), 2.0 * M * d0 * d1, f32_rate),
        ("fcnn_fused_chain", "tpu_dist_nn_torch/kernels/csrc/fcnn_chain.cu",
         "tpu_dist_nn/kernels/fused_dense.py:118",
         lambda h: fcnn_fused_forward(params, h),
         lambda h: fcnn_fused_forward_plain(params, h),
         addmm_chain, 4.0 * M * d0 + w_f32 + 4.0 * M * d3, flops_chain, f32_rate),
        ("int8_chain", "tpu_dist_nn_torch/kernels/csrc/int8_chain.cu",
         "tpu_dist_nn/kernels/quantized.py:96",
         lambda h: fcnn_quantized_forward(q, h),
         lambda h: forward_quantized(q, h),
         int_mm_chain if int_mm_ok else None,
         4.0 * M * d0 + w_i8 + 4.0 * M * d3, flops_chain, i8_rate),
    ]
    # The f32 dense kernels take less device time than a Python call and
    # its launch take on the host, so a host loop of calls would time the
    # host: they, their plain versions and their library calls are timed
    # as 50 calls captured in one CUDA graph (device time), with the host
    # loop's time printed beside. The int8 chain takes the timer
    # loop_or_graph picks for its kernel, for all three.
    records = []
    for kname, source, replaces, kern, plain, library, nbytes, ops, rate in specs:
        timer = cuda_graph_time_ms
        if kname == "int8_chain":
            timer, loop_ms, graph_ms = loop_or_graph(cycled(kern))
            print(f"time {kname} @ batch {M}: host loop {loop_ms:.4f} ms, CUDA graph "
                  f"{graph_ms:.4f} ms a call -> timed by "
                  f"{'the graph' if timer is cuda_graph_time_ms else 'the host loop'}")
        ms = timer(cycled(kern))
        plain_ms = timer(cycled(plain))
        library_ms = timer(cycled(library)) if library is not None else None
        if timer is cuda_graph_time_ms:
            print(f"time {kname} @ batch {M}, host loop of calls: kernel "
                  f"{cuda_time_ms(cycled(kern)):.4f} ms, library "
                  f"{'n/a' if library is None else f'{cuda_time_ms(cycled(library)):.4f} ms'}")
        b_ms, b_by = bound_ms(nbytes, ops, rate, mem_rate)
        records.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[{"fused_dense": "fused_dense",
                                  "fcnn_fused_chain": "fcnn_fused_forward",
                                  "int8_chain": "fcnn_quantized_forward"}[kname]],
            "max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        })
        print(f"time {kname} @ batch {M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound {b_ms:.4f} ms "
              f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops) -> "
              f"{b_ms / ms * 100:.1f}% of bound"
              f"{'' if library_ms is None else f', {ms / library_ms:.2f}x the library'}")

    # The chain at the conv network's dense tail (2048-64-10, batch 1024,
    # split-K), on 7 rotating inputs (7 x 8.4 MB > the 50 MB L2); the
    # library yardstick is the addmm chain at that shape.
    tail_ins = [x_tail] + [on_card(rng_tail.uniform(0.0, 1.0, tuple(x_tail.shape))
                                   .astype(np.float32)) for _ in range(6)]

    def addmm_tail(h):
        for p, act in zip(tail, tail_acts):
            h = apply_activation(torch.addmm(p["b"], h, p["w"]), act)
        return h

    Mt = CIFAR_BATCH
    ms = cuda_graph_time_ms(cycled(lambda h: fcnn_fused_forward(tail, h), tail_ins))
    plain_ms = cuda_graph_time_ms(cycled(lambda h: fcnn_fused_forward_plain(tail, h), tail_ins))
    library_ms = cuda_graph_time_ms(cycled(addmm_tail, tail_ins))
    print(f"time fcnn_fused_chain_conv_tail @ batch {Mt}, host loop of calls: kernel "
          f"{cuda_time_ms(cycled(lambda h: fcnn_fused_forward(tail, h), tail_ins)):.4f} ms, "
          f"library {cuda_time_ms(cycled(addmm_tail, tail_ins)):.4f} ms")
    nbytes = 4.0 * (Mt * tail_dims[0] + sum(p["w"].numel() + p["b"].numel() for p in tail)
                    + Mt * tail_dims[-1])
    ops = 2.0 * Mt * sum(a * b for a, b in zip(tail_dims[:-1], tail_dims[1:]))
    b_ms, b_by = bound_ms(nbytes, ops, f32_rate, mem_rate)
    records.append({
        "name": "fcnn_fused_chain_conv_tail", "route": "cuda",
        "source": "tpu_dist_nn_torch/kernels/csrc/fcnn_chain.cu",
        "replaces": "tpu_dist_nn/kernels/fused_dense.py:118",
        "launches": conv_launches["fcnn_fused_forward"],
        "max_abs_err": err["fcnn_fused_chain_conv_tail"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    })
    print(f"time fcnn_fused_chain_conv_tail {tail_tag} @ batch {Mt}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (addmm chain), bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops) -> "
          f"{b_ms / ms * 100:.1f}% of bound, {ms / library_ms:.2f}x the library")

    # fused_conv2d at the conv path's two stages, batch 1024, on rotating
    # inputs (5 x 12.6 MB and 4 x 16.8 MB, more than the 50 MB L2). One
    # record sums both stages: the conv kernel's share of a batch. The
    # library yardstick is cuDNN's conv on channels-last tensors (TF32
    # off), then bias, relu and max_pool2d; the port never calls it.
    conv_sum = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    conv_by = []
    for label, img, wt, bias, n_in in (("conv1+pool 32x32x3->16", img1, cw1, cb1, 5),
                                       ("conv2+pool 16x16x16->32", img2, cw2, cb2, 4)):
        ins = [img] + [on_card(rng.uniform(0.0, 1.0, tuple(img.shape)).astype(np.float32))
                       for _ in range(n_in - 1)]

        w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def library(h, w_lib=w_lib, bias=bias):
            z = F.conv2d(h.permute(0, 3, 1, 2), w_lib, bias, padding="same")
            return F.max_pool2d(torch.relu(z), 2)

        def kern(h, wt=wt, bias=bias):
            return fused_conv2d(h, wt, bias, activation="relu", **pool2)

        def plain(h, wt=wt, bias=bias):
            return fused_conv2d_plain(h, wt, bias, activation="relu", **pool2)

        lib_err = float((library(img).permute(0, 2, 3, 1) - plain(img)).abs().max())
        timer, loop_ms, graph_ms = loop_or_graph(cycled(kern, ins))
        print(f"time fused_conv2d {label} @ batch {img.shape[0]}: host loop {loop_ms:.4f} ms, "
              f"CUDA graph {graph_ms:.4f} ms a call -> timed by "
              f"{'the graph' if timer is cuda_graph_time_ms else 'the host loop'}")
        ms = timer(cycled(kern, ins))
        plain_ms = timer(cycled(plain, ins))
        library_ms = timer(cycled(library, ins))
        B, H, W, cin = img.shape
        kh, kw, _, cout = wt.shape
        ops = 2.0 * B * cout * cin * in_image_taps(H, kh) * in_image_taps(W, kw)
        nbytes = 4.0 * (img.numel() + wt.numel() + bias.numel() + B * (H // 2) * (W // 2) * cout)
        b_ms, b_by = bound_ms(nbytes, ops, f32_rate, mem_rate)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", b_ms)):
            conv_sum[key] += value
        conv_by.append((b_ms, b_by))
        print(f"time fused_conv2d {label} @ batch {B}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (cuDNN conv2d + relu + "
              f"max_pool2d; max_abs vs plain {lib_err:.2e}), bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops) -> {b_ms / ms * 100:.1f}% of bound")
    records.append({
        "name": "fused_conv2d", "route": "cuda",
        "source": "tpu_dist_nn_torch/kernels/csrc/conv2d.cu",
        "replaces": "tpu_dist_nn/kernels/conv2d.py:98",
        "launches": conv_launches["fused_conv2d"], "max_abs_err": err["fused_conv2d"],
        **conv_sum, "bound_by": max(conv_by)[1],
    })
    print(f"time fused_conv2d, both stages of one batch of {CIFAR_BATCH}: kernel "
          f"{conv_sum['ms']:.4f} ms, plain {conv_sum['plain_ms']:.4f} ms, library "
          f"{conv_sum['library_ms']:.4f} ms, bound {conv_sum['bound_ms']:.4f} ms")

    # Flash attention on rotating input sets: at the 85M shape larger than
    # the 50 MB L2 (bf16: 3 sets of a 75.5 MB fused qkv and a 25.2 MB dO;
    # float32: 2 sets of twice that); at the float32 recipe's shape (B 16,
    # H 4, T 128, Dh 32: 1 MB a tensor) 4 sets, which stay in L2 as they
    # do in the recipe's step. Each route's kernels are timed in their own
    # dtype: bf16 for the sm90 pair (the 85M path), float32 for the f32
    # pair (tdn lm's default path), whose bound is printed twice: 3xTF32
    # (three TF32 products over the TF32 peak, the kernels line's) and
    # FP32 FFMA. lse and delta come from the routed forward. The sm90
    # backward's time is its wrapper's: zeroing the float32 dq workspace,
    # the kernel, the cast of dq to bf16 (timed alone too); the f32
    # backward's includes zeroing its float32 dq. The library yardstick is
    # F.scaled_dot_product_attention(is_causal=True) on the same
    # (transposed) views in the same dtype (TF32 off): its forward, and
    # one backward call that computes dq, dk and dv together, timed 7
    # times (its time moved 0.338-0.501 ms between calls before): the
    # median is the yardstick, the spread is printed. At the recipe's
    # shape a call's host time exceeds its device time, so the kernels
    # are also timed as a CUDA graph of 50 calls.
    src_f32 = "tpu_dist_nn_torch/kernels/csrc/flash_attention_f32.cu"
    src_sm90 = "tpu_dist_nn_torch/kernels/csrc/flash_attention_sm90.cu"
    fwd_at, dq_at, dkv_at = ("tpu_dist_nn/kernels/flash_attention.py:52",
                             "tpu_dist_nn/kernels/flash_attention.py:126",
                             "tpu_dist_nn/kernels/flash_attention.py:157")
    shape_lm = (B_LM, T_LM, H_LM, DH_LM)
    shape_rc = (RECIPE["batch"], RECIPE["seq_len"], RECIPE["heads"], DH_RC)

    def shape_tag(shape):
        B, T, H, Dh = shape
        return f"B{B} H{H} T{T} Dh{Dh} causal"

    def flash_sets(shape, dtype, n, seed0):
        sets = []
        for i in range(n):
            fq, fk, fv, fdo = flash_inputs(*shape, dtype, seed=seed0 + i)
            fo, flse = flash_fwd(fq, fk, fv, causal=True)
            fdelta = (fdo.float() * fo.float()).sum(-1).transpose(1, 2).contiguous()
            lib_in = [t.transpose(1, 2).detach().requires_grad_(True) for t in (fq, fk, fv)]
            lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True)
            sets.append(dict(q=fq, k=fk, v=fv, do=fdo, lse=flse, delta=fdelta, o=fo,
                             lib_in=lib_in, lib_out=lib_out, lib_do=fdo.transpose(1, 2),
                             scale=1.0 / math.sqrt(shape[3])))
        return sets

    def rotating(sets, fn):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % len(sets)
            return fn(sets[state["i"]])
        return call

    def sdpa_times(sets, shape, label):
        fwd_ms = cuda_time_ms(rotating(sets, lambda st: F.scaled_dot_product_attention(
            *st["lib_in"], is_causal=True)))
        runs = sorted(cuda_time_ms(rotating(sets, lambda st: torch.autograd.grad(
            st["lib_out"], st["lib_in"], st["lib_do"], retain_graph=True)), iters=20)
            for _ in range(7))
        bwd_ms = float(np.median(runs))
        print(f"time SDPA @ {shape_tag(shape)} {label}: forward {fwd_ms:.4f} ms; backward (dq, "
              f"dk, dv in one call), 7 timings of 20 calls: median {bwd_ms:.4f} ms, min "
              f"{runs[0]:.4f}, max {runs[-1]:.4f} ({json.dumps([round(t, 4) for t in runs])})")
        return fwd_ms, bwd_ms

    def bwd_args(st):
        return st["q"], st["k"], st["v"], st["do"], st["lse"], st["delta"]

    # name -> (source, replaces, kernel, plain, (B, T, H, Dh) tensors moved,
    # float32 (B, H, T) rows moved, FLOP per causal pair and head dim);
    # bytes count each input read once and each output written once. The
    # backward is one function for both TPU backward kernels: q, k, v, dO,
    # lse and delta in, dq, dk and dv out; 5 products (S, dP, dV, dK, dQ).
    flash_kernels = {
        "flash_fwd_f32": (src_f32, fwd_at,
                          lambda st: flash_fwd_f32(st["q"], st["k"], st["v"], causal=True),
                          "fwd", 4, 1, 4.0),
        "flash_bwd_f32": (src_f32, f"{dq_at} and {dkv_at}",
                          lambda st: flash_bwd_f32(*bwd_args(st), causal=True), "bwd", 7, 2,
                          10.0),
        "flash_fwd_sm90": (src_sm90, fwd_at,
                           lambda st: flash_fwd_sm90(st["q"], st["k"], st["v"], causal=True),
                           "fwd", 4, 1, 4.0),
        "flash_bwd_sm90": (src_sm90, f"{dq_at} and {dkv_at}",
                           lambda st: flash_bwd_sm90(*bwd_args(st), causal=True), "bwd", 7, 2,
                           10.0),
    }
    plains = {
        "fwd": lambda st: flash_fwd_plain(st["q"], st["k"], st["v"], scale=st["scale"],
                                          causal=True),
        "bwd": lambda st: flash_bwd_plain(*bwd_args(st), scale=st["scale"], causal=True),
    }

    def time_flash(kname, sets, shape, dtype, sdpa, launches=None, err_key=None, graph=False):
        source, replaces, kern, plain_key, n_act, n_rows, flop = flash_kernels[kname]
        B, T, H, Dh = shape
        elem = 2 if dtype == torch.bfloat16 else 4
        nbytes = n_act * elem * B * T * H * Dh + n_rows * 4.0 * B * H * T
        ops = flop * B * H * causal_pairs(T) * Dh
        ms = cuda_time_ms(rotating(sets, kern))
        plain_ms = cuda_time_ms(rotating(sets, plains[plain_key]), iters=10, warmup=2)
        library_ms = sdpa[0] if plain_key == "fwd" else sdpa[1]
        if dtype == torch.bfloat16:
            b_ms, b_by = bound_ms(nbytes, ops, bf16_rate, mem_rate)
            bound_what = "at the bf16 peak"
        else:
            b_ms, b_by = bound_ms(nbytes, 3.0 * ops, tf32_rate, mem_rate)
            ffma_ms, ffma_by = bound_ms(nbytes, ops, f32_rate, mem_rate)
            bound_what = (f"3xTF32: 3 x the FLOP at the TF32 peak; FP32 FFMA bound "
                          f"{ffma_ms:.4f} ms ({ffma_by})")
        if launches is not None:
            records.append({
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kname], "max_abs_err": err[err_key], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
            })
        lib_what = ("SDPA forward" if plain_key == "fwd"
                    else "one SDPA backward call, which computes dq, dk and dv together")
        graph_what = (f", CUDA graph of 50 calls {cuda_graph_time_ms(rotating(sets, kern)):.4f} ms"
                      if graph else "")
        print(f"time {kname} @ {shape_tag(shape)} {str(dtype).split('.')[-1]}: kernel {ms:.4f} "
              f"ms{graph_what}, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
              f"({lib_what}), bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP; {bound_what}) -> {b_ms / ms * 100:.2f}% of bound, "
              f"{ops / ms / 1e9:.1f} TFLOP/s, {ms / library_ms:.2f}x the library")
        return ms

    sets = flash_sets(shape_lm, torch.bfloat16, 3, 10)
    lib_err = float((sets[0]["lib_out"].detach().transpose(1, 2).float()
                     - sets[0]["o"].float()).abs().max())
    sdpa_bf16 = sdpa_times(sets, shape_lm, "bfloat16")
    sm90_bwd_ms = 0.0
    for k in ("flash_fwd_sm90", "flash_bwd_sm90"):
        sm90_bwd_ms = time_flash(k, sets, shape_lm, torch.bfloat16, sdpa_bf16, lm_launches, k)
    workspace_ms = cuda_time_ms(lambda: torch.zeros(
        (B_LM, T_LM, H_LM, DH_LM), dtype=torch.float32, device=dev).to(torch.bfloat16))
    print(f"time flash_bwd_sm90's workspace alone (zero a float32 (B, T, H, Dh) and cast it "
          f"to bf16): {workspace_ms:.4f} ms of its {sm90_bwd_ms:.4f} ms")
    print(f"SDPA forward vs flash_fwd_sm90 at the LM shape: max_abs {lib_err:.3e}")
    del sets
    torch.cuda.empty_cache()
    # The model-parallel steps' shape (printed; the kernels line keeps the
    # 85M single program's).
    shape_mp = (B_LM // MP["micro"], T_LM, H_LM // MP["model"], DH_LM)
    sets = flash_sets(shape_mp, torch.bfloat16, 3, 50)
    sdpa_mp = sdpa_times(sets, shape_mp, "bfloat16")
    for k in ("flash_fwd_sm90", "flash_bwd_sm90"):
        time_flash(k, sets, shape_mp, torch.bfloat16, sdpa_mp, graph=True)
    del sets
    torch.cuda.empty_cache()
    # Ulysses' shape in the sequence-parallel phase (sp alone, seq 4: the
    # full sequence on 3 heads a slot).
    shape_sp = (B_LM, T_LM, H_LM // SP["seq"], DH_LM)
    sets = flash_sets(shape_sp, torch.bfloat16, 3, 60)
    sdpa_sp = sdpa_times(sets, shape_sp, "bfloat16")
    for k in ("flash_fwd_sm90", "flash_bwd_sm90"):
        time_flash(k, sets, shape_sp, torch.bfloat16, sdpa_sp, graph=True)
    del sets
    torch.cuda.empty_cache()
    # The MoE arms' attention shards (moe_phase): flat EP 2 x 2 (B 4, H 12),
    # a pp x ep microbatch's expert shard (B 2, H 12) and sp x ep Ulysses
    # at seq 2 x expert 2 (B 8, the full sequence on 6 heads).
    for shape_moe, seed in (((B_LM // 4, T_LM, H_LM, DH_LM), 70),
                            ((B_LM // (2 * MOE["micro"]), T_LM, H_LM, DH_LM), 80),
                            ((B_LM // 2, T_LM, H_LM // 2, DH_LM), 90)):
        sets = flash_sets(shape_moe, torch.bfloat16, 3, seed)
        sdpa_moe = sdpa_times(sets, shape_moe, "bfloat16")
        for k in ("flash_fwd_sm90", "flash_bwd_sm90"):
            time_flash(k, sets, shape_moe, torch.bfloat16, sdpa_moe, graph=True)
        del sets
        torch.cuda.empty_cache()
    # The f32 pair on its own route, float32, at the 85M shape (the
    # kernels line; launches from the float32 recipe's main path) and at
    # the recipe's shape.
    sets = flash_sets(shape_lm, torch.float32, 2, 30)
    sdpa_f32 = sdpa_times(sets, shape_lm, "float32")
    f32_ms = {k: time_flash(k, sets, shape_lm, torch.float32, sdpa_f32, rc_launches, k)
              for k in ("flash_fwd_f32", "flash_bwd_f32")}
    zero_ms = cuda_time_ms(lambda: torch.zeros((B_LM, T_LM, H_LM, DH_LM), dtype=torch.float32,
                                               device=dev))
    print(f"time flash_bwd_f32's dq zeroing alone: {zero_ms:.4f} ms of its "
          f"{f32_ms['flash_bwd_f32']:.4f} ms")
    for k, (lib_ms, name_) in (("flash_fwd_f32", (sdpa_f32[0], "forward")),
                               ("flash_bwd_f32", (sdpa_f32[1], "backward"))):
        print(f"check {k} below SDPA float32 {name_} at the 85M shape, this run: "
              f"{f32_ms[k]:.4f} vs {lib_ms:.4f} ms | goal, not a gate | "
              f"{'met' if f32_ms[k] < lib_ms else 'missed'}")
    del sets
    torch.cuda.empty_cache()
    sets = flash_sets(shape_rc, torch.float32, 4, 40)
    sdpa_rc = sdpa_times(sets, shape_rc, "float32")
    for k in ("flash_fwd_f32", "flash_bwd_f32"):
        time_flash(k, sets, shape_rc, torch.float32, sdpa_rc, graph=True)
    del sets
    torch.cuda.empty_cache()

    # The TPU kernel sweep's shape (artifacts/tpu_r04/kernel_sweep.json):
    # B 4, H 8, Dh 64, T 4096, causal, bf16; flash attention against the
    # materialised dot_product_attention, forward and forward + backward.
    def sweep_set(seed):
        q, k, v, do = flash_inputs(4, 4096, 8, 64, torch.bfloat16, seed)
        return [t.contiguous().requires_grad_(True) for t in (q, k, v)] + [do]

    sweep = [sweep_set(20 + i) for i in range(2)]  # 2 x 67 MB > the 50 MB L2
    for label, attn in (("flash_attention", flash_attention),
                        ("dot_product_attention", dot_product_attention)):
        def fwd(st, attn=attn):
            with torch.no_grad():
                return attn(*st[:3], causal=True)

        def fwd_bwd(st, attn=attn):
            return torch.autograd.grad(attn(*st[:3], causal=True), st[:3], st[3])

        state = {"i": 0}

        def cyc(fn):
            def call():
                state["i"] = (state["i"] + 1) % len(sweep)
                return fn(sweep[state["i"]])
            return call

        f_ms = cuda_time_ms(cyc(fwd), iters=10, warmup=2)
        fb_ms = cuda_time_ms(cyc(fwd_bwd), iters=10, warmup=2)
        print(f"time {label} @ B4 H8 T4096 Dh64 causal bf16 (the TPU sweep's shape): forward "
              f"{f_ms:.4f} ms, forward + backward {fb_ms:.4f} ms")
    del sweep
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
