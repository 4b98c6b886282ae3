"""On-card smoke run of paddle_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a), nvcc and the
port's sources beside this file. It imports nothing of JAX or of the JAX
package. Phases, each printed as one JSON line; any failure raises and
the script exits non-zero without its final line.

Launch counts: a kernel's wrapper counts the launches it makes, and a
phase's count runs from its first step on. A graphed window's first
step runs eagerly, through the wrappers; the capture and the replays
call none, so after the timed replays more replays are traced with
torch.profiler, TRACE_TRIES of them, and the kernels of the most
complete trace are counted by name (``traced_launches``,
``complete_trace``). The kernels line gives both: ``launches`` (the
wrappers') and ``replay_launches`` (the traced replay's).

1. card      nvidia-smi name and power limit; build every CUDA kernel;
             each fused-attention kernel's registers and spills (ptxas)
             and shared memory a block.
2. kernels   each kernel against its plain PyTorch version at the main
             paths' shapes and at the edge cases, with its time (CUDA
             events, median of 25 cold-L2 launches), the plain
             version's, one PyTorch library call's where one computes the
             same function, and the least time the card could take. The
             times are device time: the host's launch overhead is kept
             out of the timed span. Decode attention: ragged capacity,
             causal window (its bound counts V over the capacity for a
             batch row with an empty window), the speculative verify
             step's shape (batch 8, 16 heads, Q 4 under the causal
             window, lengths 68-96; untimed at 125-132, either side of
             the first piece's end), wrapped ring, paged at the
             serving path's shape, at its serving phase's short
             lengths (33-96) and with one long slot (2 slots, 64
             pages of 128, lengths 8192 and 3000) against the plain
             version and the dense kernel on the gathered cache; fp32
             and bf16; each timed case with the pieces its key axis
             was cut into, blocks, shared memory a block, registers
             (decode_attention.log), and the path and paged cases also
             timed at other forced piece counts; untimed,
             dense and paged, key rows of 16 and 192 bytes (bf16 d 8,
             fp32 d 48, bf16 d 96), fp16, rows that are not a multiple
             of 16 bytes (fp32 d 6, bf16 d 12), rows past 512 bytes
             (fp32 d 192 and 512, bf16 d 512) and past 2048 bytes,
             split across blocks (fp32 d 640, bf16 d 1536), also padded
             to 16 bytes as the sessions hold them. Fused training
             attention (forward, and the backward's dq, dk, dv and
             dbias; up to d 128 on the tensor cores, fp32 as 3xTF32
             with its backward up to d 64; TFLOP/s beside each time):
             BERT-base's shape
             (batch 32, 12 heads of 64, S 512, padding-mask bias) at
             dropout 0.1 and 0, every other bias mode, a ragged S and
             d 128; fp32 and bf16 (fp32 also with its bound at the SIMT
             rate and the kernels SDPA ran, by the profiler's names);
             untimed, head widths 48, 80 and 160 (zero-padded to 64, 128
             and 256), 256, 320 and 512 (past 256 the outputs' columns
             split across blocks) in fp32, bf16 and fp16, and fp16 at
             BERT-base's shape. The same
             kernels past S 1024, where they stand in for the TPU
             package's long and flash tiers: batch 1, 12 heads of 64, at
             S 2048, 4096 and 8192, p = 0, fp32 and bf16, each kernel of
             the backward also timed alone; at S 2048 dropout 0.1 and a
             per-row [1, 12, S, S] bias; untimed, bf16 at dropout 0.1 at
             each shape of bert_long (S 2048 x 8, 4096 x 4, 8192 x 2; at
             S 8192 the plain version runs one (batch, head) pair at a
             time). Each output of these is held to a limit relative to
             the plain output's largest magnitude (LONG_RTOL). The same
             kernels on packed [B, S, H*d] operands, through the heads'
             strides, at the bert_packed path's shapes: BERT-base at
             batch 128, S 128 (the TPU's resident tier) with a padding
             mask and with a per-head bias, and BERT-tiny at batch 128,
             S 128 (4 heads of 16: the TPU's packed tier), p 0 timed and
             p 0.1 untimed; untimed, batch 8, S 256, 3 heads (an odd H);
             fp32 and bf16, held to LONG_RTOL; and the packed entry equal
             to the per-head one on contiguous copies at p 0.1.
3. dense     GenerativePredictor(Transformer.big(), batch 64, src 128,
             prompt 64, capacity 1024).run for 32 new tokens: the dense
             decode kernel launches once per decoder layer per step, and
             one whole-model decode step with the kernels agrees with the
             same step on the plain versions.
4. serving   GenerativeServer over the paged stream (width 8, pages of
             128 tokens, 25-page pool, prefix cache of 8): 16 requests
             from 4 threads, some repeated; every future resolves through
             the paged kernel and the prefix cache hits.
5. bert      BERT-base MLM pretraining at S 512 through the Program IR:
             build_pretrain_program -> Executor.run (startup, then train
             steps) on one synthetic batch of 32. One step with the fused
             kernels agrees with the same step on the plain attention from
             a cloned scope and generator (``bert_step_check``; each
             route runs eagerly, ``route_step``); then a warm step (12
             forward and 12 + 12 backward launches through the
             wrappers, all on the tensor cores, 3xTF32), the step
             captured into a CUDA graph (the executor's default), the
             timed replays and one traced replay naming the same 36
             kernels, with finite losses that fall (the batch is
             memorised).
6. bert_long BERT-base long-context pretraining in bf16 AMP
             (use_amp=True, dropout 0.1, max_seq = S), the reference's
             long-sequence run: first one step with the kernels against
             one with the plain attention at S 2048, batch 1, from a
             cloned scope and generator, at data seeds 0-5, judged
             together (``step_verdict``); then (S 2048, batch 8),
             (S 4096, batch 4) and (S 8192, batch 2), each a warm step,
             its capture (``Executor.close()`` drops each shape's graph),
             4 timed replays and one traced; the warm step and the traced
             replay each through 12 forward (all attn_fwd_mma, the
             tensor-core forward), 12 dq and 12 dk/dv launches,
             reported under the TPU tier they stand in for
             (``reference_tier``: long at S 2048, flash above), with
             finite losses that fall.
7. bert_packed  BASELINE config 3 in the packed layout: BERT-base MLM
             pretraining at batch 128, S 128, bf16 AMP with
             use_fused_attention="packed" (the reference's bench_bert
             shapes): one step against the plain attention at batch 2,
             at data seeds 0-5, judged together; a warm step, its
             capture, 4 timed replays and a traced one, the warm step
             and the traced replay each through 12 forward
             (attn_fwd_mma), 12 dq and 12 dk/dv launches on the heads'
             strided views (the
             program's only attention op is the packed one), with
             falling losses; the same with "auto" (the einsum chain) and
             True (per-head kernels behind transposes) for their step
             times; BERT-tiny at the same shapes, which the TPU runs in
             its packed tier.
8. executor  config 3 through the executor's CUDA graphs against its
             eager steps (``executor_path``): 10 steps at p 0 from one
             cloned state (losses and first moments equal to the bit,
             replays, launches);
             iters=4 against four single graphed runs, async handles
             against sync fetches; at p 0.1 replays against eager steps
             and the masks changing between replays; the *_mma kernels
             by name in a profiler trace of one replay and the host's
             launch calls a step, graphed and eager; step times, peak
             memory and replays, graphed and eager in turns.
9. encoder_serving  a BERT-base packed encoder saved with
             save_inference_model, loaded as a Predictor behind a Server
             (batches up to 32, 2 ms delay, ladder warmed up and
             captured): 64 requests of 1-4 rows from 8 threads, each held
             to a direct Predictor.run of its rows with capture off;
             latency, occupancy, launches (from the warm-up on, and a
             traced replay), replays, memory; then the same with the
             served predictor's capture off.
10. lenet    BASELINE config 1 as bench.py's bench_lenet feeds it:
             LeNet-5, batch 1024, fp32, Adam, graphed; 3 steps graphed
             against 3 eager from one state (losses and every
             persistable equal to the bit, and two eager runs equal to
             each other), then 10 steps and timed iters=100 windows:
             images/s and step ms; falling losses.
11. resnet   BASELINE config 2 as bench.py's bench_resnet feeds it:
             ResNet-50, batch 256, 224x224, bf16 AMP, Momentum(0.9) +
             L2Decay(1e-4), random images and labels made on the card,
             graphed. Per layout (NCHW, the reference's default, and
             NHWC): 3 graphed steps against 3 eager ones from one state
             (losses, every parameter, velocity and batch-norm running
             statistic equal to the bit; two eager runs too), the
             convolution kernels of the eager step and of a traced
             replay equal by name (cuDNN chose them outside the
             capture); then timed rounds NCHW, NHWC, NHWC, NCHW: images/s,
             step ms, device-busy ms and idle share, host launch calls a
             step, peak allocated and reserved GB, the five kernels with
             the most device time, and MFU against 989 TFLOP/s with the
             FLOPs counted from the program's conv2d and mul shapes (3x
             the forward's); every AMP loss finite. ResNet-18 fp32 at
             64x64, batch 8, 3 steps on the card against the port's CPU
             path (rtol 1e-4, the largest difference printed); the
             trained ResNet-50 served by a Predictor at batch 32 against
             an eager run of the for_test clone (SERVE_ATOL). No
             hand-written kernel runs here: the reference has no Pallas
             convolution, pooling or batch norm, so these lower to
             cuDNN and ATen.
12. deepfm   BASELINE config 4 as bench.py's bench_deepfm feeds it:
             DeepFMConfig() (vocabulary 100,000, 26 fields, 13 dense
             features, embedding 10, MLP 400x3), is_sparse=True, Adam
             lr 1e-3, batch 4096, graphed. 3 graphed steps against 3
             eager ones from one state (losses and every persistable
             equal to the bit); an eager step's SelectedRows gradients
             ([106496, dim] values, [106496] rows) with no aten op
             making a [vocab, ...] tensor, and after 3 graphed steps the
             rows the batch does not touch, and their Adam moments,
             equal to the bit; sparse against dense over 5 steps on one
             batch (losses within DEEPFM_SPARSE_DENSE_RTOL, every
             persistable within DEEPFM_SPARSE_DENSE_STATE_RTOL); 3
             steps on the card against the port's CPU path and its
             float64 run (every loss, and the state after step 1,
             within DEEPFM_CPU_RTOL or 3x the fp32 noise; after steps
             2-3 each tensor's L2 difference over the L2 norm of its
             update within DEEPFM_CPU_UPDATE_RTOL or 3x the CPU's own
             against float64); step
             ms and examples/s eager, graphed and in iters=100 windows,
             the idle share, device kernels and host launch calls a step
             from traces, peak GB; the trained pred served by a
             Predictor at batch 4096 against a training step's pred
             (DEEPFM_SERVE_ATOL), its request ms. No attention kernel
             runs (counted: 0); the ops lower to torch's own calls.
13. host_embedding  the host embedding tier and dataset feeding, on the
             card with no CPU fallback: bench.py's bench_embedding shape
             (vocabulary 65,536, 16x a 4096-row budget, batch 256, 8
             fields, 8 dense, embedding 16, fc 64x64, Adam, fresh uniform
             ids every step): 30 graphed steps without prefetch and 30
             with embedding.prefetch(main, next_feed), steps/s both ways,
             lookup p50/p99 (embedding_lookup_seconds), prefetch hits and
             evictions (both > 0), no state copied into a graph; then
             grow(2 x vocab) and 3 steps with no new capture and no new
             compile-cache miss. Config 4's widths at batch 4096 with
             fm_emb on a table of 33,762,577 rows (the Criteo Kaggle
             set's distinct values, DLRM's count) behind a 262,144-row
             cache, fm_w1 on the device tier: 5 warm and 20 timed graphed
             steps with prefetch, steps/s, examples/s, lookup p50/p99,
             evictions a step, the prefetch hit share, the idle share of
             a trace of 3 steps, peak device GB, host store GB. Config 4
             (vocabulary 100,000) at batch 1024 with a 32,768-row cache
             against the device tier from one state over 10 graphed
             steps: losses and the flushed host store and moments within
             HOST_VS_DEVICE_RTOL, evictions, bit-equality printed; the
             host tier graphed against eager, to the bit. Eight batches
             of config-4 samples at batch 4096 written as MultiSlot
             files, one pass of a host-tier program (vocabulary
             1,000,000, 131,072-row cache) by train_from_dataset against
             a plain exe.run loop in a fresh scope: the flushed host
             store, its moments and every device persistable equal to
             the bit; wall, examples/s, reader_prefetch_stall_seconds
             p50. No attention kernel runs (counted: 0).
14. transformer_train  BASELINE config 5's training as bench.py's
             bench_transformer runs it: Transformer.big(32000, 32000)
             under dygraph.guard() (seed 0), one synthetic batch of 32 x
             64 tokens. 3 eager dygraph steps of Adam(1e-4) through
             opt.minimize(loss, parameter_list=model.parameters())
             (losses falling, step ms, ops traced a step); in eval() the
             eager output against jit.trace's program run by the executor
             (TFM_TRACE_RTOL); the program traced in training mode
             (dropout 0.1) with the loss and mixed_precision.decorate(
             Adam(1e-4)) appended, its scope binding the model's own
             parameter storage: graphed against eager over 3 steps from
             one state (losses and every persistable equal to the bit),
             then step ms, tokens/s, device busy and idle share, kernels
             and launch calls a step, peak GB and MFU against 989 TFLOP/s
             (bench.py's FLOP count, ``transformer_train_flops_per_step``),
             graphed and by the eager executor; full width at depth 2,
             batch 4, fp32, p 0, 3 Adam steps graphed on the card against
             the port's CPU path and its float64 run (every loss within
             TFM_CPU_RTOL, every state by the L2 of its update within
             TFM_CPU_UPDATE_RTOL, each or 3x the CPU's own against
             float64). No attention kernel runs (counted: 0, by the
             wrappers and by name in the traced steps): the reference's
             training forward has matmul / softmax attention.
15. checkpoint  config 3 (BERT-base, batch 128, S 128, bf16 AMP,
             packed, dropout 0.1) built by build_pretrain_program with
             py_reader_batch=128, fed by its py_reader over 16 seeded
             batches, every run from clones of one startup state:
             prefetched iters=4 windows against inline ones in turns
             (trajectories equal to the bit; step ms, tokens/s, the
             executor_window_* series); 12 uninterrupted steps (and the
             attention kernels of a traced replay by name, 12 each); the
             same 12 with checkpoint=(CheckpointManager(max_to_keep=2,
             background=True), 4) and a non-finite step 6 under the
             rollback policy (back at the step-4 version to the bit,
             scope, generator and reader; no state tensor rebound; the
             next replay equal to a fresh eager step from the version;
             the committed trajectory and final state equal to the
             uninterrupted run's; each save's snapshot ms, write s,
             sha256 s and bytes, the restore s); a child process
             SIGTERM'd after step 6 (drain: force-save, marker, exit 0)
             and a second resuming with restore_on_restart, its steps
             7-12 and final state equal to the uninterrupted run's.
16. recompute  BERT-base with RecomputeOptimizer(Adam), each encoder
             layer's output a checkpoint: at S 512, batch 32, fp32,
             dropout 0.1, 4 graphed steps with recompute equal to 4
             without, to the bit (losses and every persistable); the
             attention forward 24 launches a step (the eager step's
             wrappers and a traced replay), dq and dk/dv 12; peak GB,
             step ms, tokens/s both ways. At S 8192 in AMP: batch 2
             both ways and batch 8 with recompute (or the largest batch
             batch 2's peak says fits): peak GB and step ms, the peaks
             lower with recompute.
17. cold_start  the encoder_serving phase's BERT-base encoder exported
             with save_inference_model(prelower=True) at its ladder's
             batch sizes (1-32): export s, the bytes of __prelowered__/,
             its entries and kernel libraries. Then three fresh child
             processes (subprocess, ``--cold-start-child``), each with
             an empty PADDLE_COMPILE_CACHE_DIR, build a Predictor and a
             Server with the ladder's warm-up and answer one request,
             timed from spawn in parts (import, load, warm-up, answer):
             (1) from __prelowered__/ with no _build/ in reach: 0 nvcc
             runs, one disk hit per ladder size, 0 live compiles; (2)
             __prelowered__/ moved aside, the cache dir that (1) filled:
             the same; (3) __prelowered__/kernels/'s library truncated,
             a fresh cache dir, the checkout's _build/ in reach: the
             library quarantined, the answer right (nvcc runs and their
             seconds printed). Each answer within SERVE_ATOL of the
             parent's Predictor.run of the same rows.
18. fleet    a CoordServer, a Router and a FleetSupervisor of two
             replica processes over that export (a shared compile cache,
             no _build/ in reach), 8 FleetClient threads sending the
             encoder_serving phase's 64 requests; each replica
             registers with 0 live compiles and 0 nvcc runs; every
             answer within SERVE_ATOL of a direct Predictor.run of its
             rows; one replica SIGTERM'd mid-traffic drains (exit 0, its
             marker), nothing lost, respawned with 0 live compiles (s
             from SIGTERM to its registration); request p50/p99 through
             the fleet beside an in-process Server's (a Replica in this
             process), fleet_requeued_total; one traced request is one
             trace from the client through the router and a replica to
             executor.run; a traced replay of the in-process replica's
             graph runs the attention forward 12 times (once a layer).
19. seq2seq  the Fluid book's GRU seq2seq (models/seq2seq.py) at its
             machine-translation widths: dictionaries of 30000 on both
             sides, embedding and hidden 512, padded length 50, batch
             64, Adam, fp32 with TF32 off. Training: 3 graphed steps
             against 3 eager from one state (losses and every
             persistable equal to the bit), 30 timed replays on one
             memorised batch (step ms, target tokens/s, peak GB, the
             program build and capture s, kernels a replay and the idle
             share of a traced one; the loss falls), and one step at
             batch 8 graphed on the card against the port's CPU run and
             its float64 run from the CPU's startup state (the loss
             within S2S_CPU_RTOL, every persistable by the L2 of its
             update within S2S_CPU_UPDATE_RTOL). Beam decode (beam 4,
             50 steps) from the trained scope at batch 64: the
             monolithic program eager, captured and replayed, the split
             pair (encoder once, its state fed on the device), and the
             decode program saved by save_inference_model and served by
             a Predictor, all the same sequences; ms per decoded batch
             both routes; the products and the beam search's top-k
             kernels of a traced replay by name; at batch 8 the card's
             per-step selections against the CPU's, equal or parting
             only at a near-tie (S2S_NEAR_TIE). No attention kernel runs
             (counted: 0).
20. book     word2vec at the book's widths (dictionary 2073, embedding
             32, hidden 256, batch 100) on Adam with
             exponential_decay(1e-3, 100, 0.9, staircase=True) and
             GradientClipByGlobalNorm(5.0): 5 graphed steps against 5
             eager to the bit; @LR_STEP@ set to 96, then 7 runs whose
             learning rate each equals the closed form at the counter
             the run left (it crosses the staircase at 100 inside the
             replays); steps/s and the idle share. VGG16-BN
             (models/vgg.py, width 1.0, CIFAR-10 3x32x32, batch 128,
             dropout at its built rates): 3 graphed steps against 3
             eager to the bit, the convolution kernels of an eager step
             and of a traced replay equal by name, images/s, step ms,
             peak GB, idle share. No attention kernel runs.
21. sentiment  the book's chapter 6 nets (models/sentiment.py) at its
             widths: dictionary 5147, embedding 128, hidden 512, 3
             stacked LSTMs, batch 128, Adam, fp32 with TF32 off, on
             reviews drawn from a seed (lengths 24-400, 32768 rows, the
             time bound 448: SNT_BOUND_RULE). Each net: graphed against
             eager to the bit (the LSTM net 2 steps), 10 timed replays
             (step ms, real tokens/s, peak GB, capture s, kernels a
             replay and the idle share of a traced one; the loss falls),
             a batch of other lengths in the same buckets replayed with
             no new capture (the conv net: one with a 500-word review,
             time bound 512, captured anew), one step at batch 8 on the
             card against the CPU and float64 (the loss within
             SNT_CPU_RTOL, each persistable by the L2 of its update
             within SNT_CPU_UPDATE_RTOL); then one train_from_dataset
             pass of the conv net over a MultiSlot file with a ragged
             word slot. The phase's seconds. No attention kernel runs.
22. tagger   the book's semantic-role tagger (models/tagger.py:
             embedding, fc, dynamic_gru, emission fc, linear_chain_crf;
             crf_decoding) at the book's widths: dictionary 44068,
             embedding 32, hidden 512, 59 tags, batch 10, Adam 5e-3,
             fp32 with TF32 off, on sentences drawn from a seed
             (lengths 5-60, the time bound from SNT_BOUND_RULE):
             graphed against eager to the bit, 10 timed replays (step
             ms, real tokens/s, peak GB, capture s, kernels a replay and
             the idle share of a traced one; the loss falls), the decode
             program on the trained scope (eager, captured, replayed, and
             on the CPU: the same Viterbi paths), one step at batch 4 on
             the card against the CPU and float64 (TAG_CPU_RTOL, each
             persistable by the L2 of its update within
             TAG_CPU_UPDATE_RTOL). The phase's seconds. No attention
             kernel runs.
23. recommender  the book's MovieLens recommender
             (models/recommender.py: user and movie towers, cos_sim,
             square_error_cost, reduce_mean) at its vocabularies and
             widths, batch 256, SGD 0.2, 1-6 categories and 1-15 title
             words a film: graphed against eager to the bit, 20 timed
             replays (step ms, examples/s, peak GB, kernels a replay and
             the idle share), one step at batch 32 against the CPU and
             float64. The phase's seconds. No attention kernel runs.
24. control_flow  the PTB language model of PaddlePaddle/models'
             lm_model.py, "large" (PTB: vocabulary 10000, 2 LSTM layers
             of 1500 written as matmul / split / sigmoid / tanh in one
             StaticRNN, 35 steps, batch 20, dropout 0.65, SGD 1.0 under
             GradientClipByGlobalNorm(10)), on token ids from a seed:
             graphed against eager to the bit, 10 timed replays (step
             ms, tokens/s, peak GB, kernels a replay and the idle
             share), one step at dropout 0 on the card against the CPU
             and float64 (PTB_CPU_RTOL, each persistable by the L2 of
             its update within PTB_CPU_UPDATE_RTOL); from the trained
             state a greedy decode of 50 tokens at batch 20 through
             layers.While with tensor arrays (eager by the executor's
             control_flow rule, 3 runs) and as while_loop(
             maximum_trip_count=50) (captured, replayed): equal tokens,
             both decodes' ms, the While decode's first logits within
             PTB_LOGITS_ATOL of the CPU's; cond, switch_case, IfElse and
             DynamicRNN on the card against the CPU (CF_ATOL). The
             phase's seconds. No attention kernel runs.
25. stream   the dense continuous stream, GenerativePredictor(...,
             slot_prefill=True).open_stream() at width 8 (bench.py's
             decode-engine legs): 16 requests of ragged prompt lengths
             and budgets joined and stepped, each equal to its solo run
             in the stream, with end_id a token only one request emits
             (so that request ends on it), where there is one; the decode
             kernel L times a step and the paged kernel never; one
             scatter a decoding join, its device kernels from a trace;
             one step with slots at mixed lengths and some idle held to
             the plain version (STEP_LOGITS_ATOL); step ms, occupancy,
             the idle share of a traced window of steps; then the same
             requests through GenerativeServer from 4 threads (p50, p99,
             each equal to its solo run).
26. speculative  build_speculative_session over a dense session at batch
             8, k 4, full prompts, 12 and 32 new tokens, draft depth 3
             (the default, L // 2) and 6: tokens equal to the dense
             session's row by row (a row may differ only where the dense
             run's top-two logit gap is under STEP_LOGITS_ATOL, and one
             row at most); the full-depth draft accepts k a round (else
             the first round that did not, with its gap); the verify
             step's logits (Q k under the causal window on the decode
             kernel) against the plain version from one prefilled
             state; rounds, accepted mean, target and draft launches,
             tokens/s beside the dense session's, the idle share of a
             traced generate.
27. summary  the kernels line, the card line, then the result line.
Every card memory line (after each phase) gives the seconds since the
one before and the smoke's seconds so far.
"""

import collections
import contextlib
import json
import math
import os
import re
import resource
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,      # fp32, no tensor cores
                  torch.bfloat16: 989e12,    # bf16 tensor cores, dense
                  torch.float16: 989e12}     # fp16 the same
# The fused attention's least time: fp32-accurate products on the tensor
# cores take three TF32 products each (3xTF32, 494.7 TFLOP/s dense), so
# about 165 TFLOP/s, which beats the SIMT cores' 67; the 16-bit types at
# the tensor cores' rate. Decode, bound by bytes, keeps PEAK_OPS_PER_S.
TF32_OPS_PER_S = 494.7e12
FUSED_PEAK_OPS_PER_S = dict(PEAK_OPS_PER_S)
FUSED_PEAK_OPS_PER_S[torch.float32] = TF32_OPS_PER_S / 3
REPS, WARMUP = 25, 3
HOLD_CYCLES = 2_000_000            # about 1 ms of SM clock
FP32_ATOL, BF16_ATOL = 2e-5, 2e-2
# fused training attention, kernel vs plain, as a share of max(1, the
# plain result's largest magnitude): fp32 sums in another order; bf16
# outputs are rounded to bf16 by both, at different points (fp16, with
# three more mantissa bits, is held to bf16's limit)
FUSED_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2,
              torch.float16: 3e-2}
PAGED_VS_DENSE_ATOL = 1e-6
# whole-model fp32 step, kernel vs plain: about ten times the 1.1e-6 to
# 1.3e-6 read on the H100 (PERF.md), so a wrong live window in one layer
# fails it
STEP_LOGITS_ATOL = 1e-5


def emit(**rec):
    print(json.dumps(rec), flush=True)


# the perf_counter of the smoke's start, then of the last card_memory line
PHASE_CLOCK = []


def card_memory(after):
    """The seconds since the previous card_memory line (the first: since
    the smoke started) and the card's memory after phase ``after``:
    this process's allocated
    and reserved GiB (a live CUDA graph keeps its pool reserved), the
    same after a garbage collection and ``empty_cache`` (the reference
    cycles that outlive a phase), the card's free GiB, and every process
    that holds memory on it (nvidia-smi). A capture whose cuDNN
    workspace cannot be allocated falls back to another algorithm than
    the eager step ran (tools/conv_capture_check.py), so what holds the
    card between phases is read here."""
    import gc

    def now():
        return dict(allocated_gib=torch.cuda.memory_allocated() / 2 ** 30,
                    reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                    free_gib=torch.cuda.mem_get_info()[0] / 2 ** 30)
    before = now()
    gc.collect()
    torch.cuda.empty_cache()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    t = time.perf_counter()
    since = t - PHASE_CLOCK[-1] if PHASE_CLOCK else None
    smoke_s = t - PHASE_CLOCK[0] if PHASE_CLOCK else None
    PHASE_CLOCK.append(t)
    emit(phase="card", check="memory", after=after,
         seconds_since_previous=since, smoke_s=smoke_s, **before,
         after_collect=now(), processes=apps, own_pid=os.getpid())


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def kernel_resources(_build, A):
    """Each fused-attention kernel's registers and spills, as ptxas
    reported them when this build compiled it (``-Xptxas -v``, kept in
    ``_build/fused_attention.log``), and its dynamic shared memory a
    block, from the library itself; one record per kernel, head width
    and type."""
    with open(os.path.join(_build.BUILD_DIR, "fused_attention.log")) as f:
        log = f.read()
    types = {"f": ("float", torch.float32),
             "13__nv_bfloat16": ("bf16", torch.bfloat16),
             "6__half": ("f16", torch.float16)}
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(attn_\w+?)I"
                      r"(f|13__nv_bfloat16|6__half)(?:Li(\d+))?E", line)
        if m:
            kind, dtype = types[m.group(2)]
            # the kernels past d 256 take d at run time: "wide"
            d = int(m.group(3)) if m.group(3) else "wide"
            cur = dict(kernel="%s<%s%s>" % (m.group(1), kind, (
                ", %d" % d) if m.group(3) else ""), d=d)
            which = ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkdv").index(
                re.sub("_(mma|tf32x3|wide)$", "", m.group(1)))
            cur["smem_bytes"] = A.fused_attention_smem_bytes(
                which, dtype, 320 if d == "wide" else d)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def time_ms(fn, flush, clean=False):
    """Median milliseconds of ``fn`` over REPS launches, each timed with
    CUDA events after a write of 128 MiB that evicts the 50 MB L2 (with
    ``clean``, a read of it: the L2 then holds no dirty lines whose
    write-back ``fn`` would pay, as a decode step finds it, after
    products that read far more than they write). The stream then spins
    for about a millisecond before the start event, so the host has
    queued all of ``fn`` by the time it starts: the span is device work,
    not the host's launch overhead."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        if clean:
            flush.max()
        else:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_times(prof):
    """{kernel name: (device us, calls)} from a finished torch.profiler
    profile."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = (us, e.count)
    return out


def device_kernels(fn):
    """The CUDA kernels one call of ``fn`` runs, by the profiler's names
    (which backend a PyTorch call took), with their device microseconds;
    "not measured" where the profiler returned no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {name[:120]: us for name, (us, _) in kernel_times(prof).items()
            } or "not measured"


def bound(q, live_cols, extra_bytes, v_cols=None):
    """(bound_ms, bound_by) for decode attention of q [B, H, Q, d] over
    ``live_cols`` live key columns in total (summed over the batch):
    bytes = q + live K rows + V rows (``v_cols`` of them, else the live
    ones) + output + ``extra_bytes``; operations = 4 d per (row, live
    column, head) (QK^T and PV) at the peak rate of the input type."""
    B, H, Q, d = q.shape
    e = q.element_size()
    v_cols = live_cols if v_cols is None else v_cols
    nbytes = 2 * q.numel() * e + (live_cols + v_cols) * H * d * e + \
        extra_bytes
    ops = 4.0 * d * Q * H * live_cols
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


DECODE_TYPES = {"f": torch.float32, "13__nv_bfloat16": torch.bfloat16,
                "6__half": torch.float16}


def decode_resources(_build):
    """Registers and spills of each decode kernel as ptxas reported them
    when this build compiled it (``-Xptxas -v``, kept in
    ``_build/decode_attention.log``): {(dtype, lanes, slices a lane, q-rows
    a block, "DenseKV" or "PagedKV"): {...}} for the split kernel,
    {(dtype, "combine"): {...}} for the combine."""
    with open(os.path.join(_build.BUILD_DIR, "decode_attention.log")) as f:
        log = f.read()
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?decode_attention_"
                      r"(kernel|combine)I(f|13__nv_bfloat16|6__half)"
                      r"(?:Li(\d+)ELi(\d+)ELi(\d+)E\S*?(DenseKV|PagedKV))?",
                      line)
        if m:
            dtype = DECODE_TYPES[m.group(2)]
            cur = (dtype, "combine") if m.group(1) == "combine" else (
                dtype, int(m.group(3)), int(m.group(4)), int(m.group(5)),
                m.group(6))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return out


def decode_smem_bytes(A, dtype, d, Q, npages=0):
    """(key columns a tile, dynamic shared memory a block) of the split
    decode kernel for rows of ``d`` elements of ``dtype`` and Q q-rows,
    with a page table of ``npages`` entries a slot (0: the dense cache),
    as csrc/decode_attention.cu sizes them (``tile_rows``, ``rows_smem``:
    a ring of 3 stages of at most 16 KB of K and V rows, which the row
    groups' fp32 accumulators reuse, then their sums, the rows' maxima
    and the page indices); for the records only."""
    e = dtype.itemsize
    lanes, per_lane = A.decode_lanes(d * e)
    rows = A.decode_block_rows(Q, d * e)
    dp = -(-d * e // 16) * 16 // e
    tile = min(32, 16384 // (2 * 16 * lanes * per_lane))
    groups = 128 // lanes
    front = max(e * 3 * 2 * tile * dp, 4 * groups * dp)
    return tile, front + 4 * (groups + rows * 4) + 4 * npages


def decode_launch(A, resources, q, capacity, npages=0, longest=None):
    """How a decode wrapper launches for q at ``capacity`` columns and
    the host's ``longest``: the pieces (``decode_pieces``), the blocks of
    the split kernel, its q-rows a block, key columns a tile and shared
    memory a block, and the registers and spills of it and of the combine
    (run when the pieces are more than one). Rows past 2048 bytes take
    ``decode_attention_wide``, which these records do not cover."""
    B, H, Q, d = q.shape
    piece, splits = A.decode_pieces(B, H, Q, capacity, d, q.dtype,
                                    A._sm_count(q.device), longest)
    lanes, per_lane = A.decode_lanes(d * q.element_size())
    rows = A.decode_block_rows(Q, d * q.element_size())
    tile, smem = decode_smem_bytes(A, q.dtype, d, Q, npages)
    key = (q.dtype, lanes, per_lane, rows,
           "PagedKV" if npages else "DenseKV")
    return dict(splits=splits, piece=piece,
                blocks=splits * -(-Q // rows) * B * H,
                block_rows=rows, tile_keys=tile, smem_bytes=smem,
                kernel_resources=resources.get(key, "not in the log"),
                combine_resources=resources.get((q.dtype, "combine"),
                                                "not in the log")
                if splits > 1 else None)


def split_sweeps(A, fn, flush, capacity, counts):
    """The rule's alternatives, timed beside its choice: {pieces: ms} of
    ``fn(splits)`` at each forced count, after a write of the flush
    buffer (``kernel_ms_by_splits``) and after a read of it
    (``kernel_ms_by_splits_clean_l2``)."""
    out = {}
    for key, clean in (("kernel_ms_by_splits", False),
                       ("kernel_ms_by_splits_clean_l2", True)):
        times = out[key] = {}
        for s in counts:
            n = -(-capacity // A.decode_piece(capacity, s))
            if n not in times:
                times[n] = time_ms(lambda: fn(n), flush, clean)
    return out


def dense_inputs(dev, gen, B, H, Q, C, d, lens, dtype=torch.float32):
    """q [B, H, Q, d], a ring cache k, v [B, H, C, d] and its lengths."""
    q, k, v = (torch.randn(*s, device=dev, generator=gen).to(dtype)
               for s in ((B, H, Q, d), (B, H, C, d), (B, H, C, d)))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


def paged_inputs(dev, gen, B, npages, pool_pages, lens):
    """q [B, 16, 1, 64], pools of 128-token pages and tables for slots of
    ``lens``: slots of length 1 keep their whole table on scratch page 0,
    as idle slots do, the others take pages of a permuted pool."""
    H, d, ptok = 16, 64, 128
    k_pool, v_pool = (torch.randn(pool_pages, H, ptok, d, device=dev,
                                  generator=gen) for _ in range(2))
    q = torch.randn(B, H, 1, d, device=dev, generator=gen)
    table = torch.zeros(B, npages, dtype=torch.int32, device=dev)
    pages = (torch.randperm(pool_pages - 1, device=dev, generator=gen)
             + 1).tolist()
    for b, n in enumerate(lens):
        if n > 1:
            need = min(npages, -(-n // ptok))
            table[b, :need] = torch.tensor(pages[:need], device=dev)
            pages = pages[need:]
    return q, k_pool, v_pool, table, torch.tensor(lens, dtype=torch.int32,
                                                  device=dev)


def dense_case(A, dev, gen, flush, name, B, H, Q, C, d, lens, dtype,
               causal=False, timed=True, resources=None, sweep=()):
    """The dense decode kernel against the plain version (and, timed,
    beside SDPA and its bound); ``sweep`` times forced piece counts."""
    q, k, v, cache_len = dense_inputs(dev, gen, B, H, Q, C, d, lens, dtype)
    scale = 1.0 / math.sqrt(d)
    longest = max(lens)     # as a session holds it on the host
    got = A.decode_attention_kernel(q, k, v, cache_len, scale, causal,
                                    longest)
    want = A._ref_attention_cache(q, k, v, cache_len, scale, causal)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    if not err <= atol:
        raise AssertionError("%s: decode kernel vs plain max |err| %g > %g"
                             % (name, err, atol))
    rec = dict(name=name, B=B, H=H, Q=Q, C=C, d=d, dtype=str(dtype),
               causal=causal, max_abs_err=err, atol=atol)
    if not timed:
        return rec
    valid = torch.clamp(cache_len, max=C).view(B, 1, 1, 1)
    col = torch.arange(C, device=dev).view(1, 1, 1, C)
    limit = valid - (Q - 1) + torch.arange(Q, device=dev).view(1, 1, Q, 1) \
        if causal else valid
    mask = col < limit
    live_k = torch.clamp(torch.clamp(cache_len, max=C), min=1)
    # a causal row whose window is empty averages V over the capacity
    live_v = torch.where(live_k - (Q - 1) <= 0, C, live_k) if causal \
        else live_k
    b_ms, b_by = bound(q, int(live_k.sum()), 4 * B, int(live_v.sum()))
    rec.update(
        kernel_ms=time_ms(lambda: A.decode_attention_kernel(
            q, k, v, cache_len, scale, causal, longest), flush),
        kernel_ms_clean_l2=time_ms(lambda: A.decode_attention_kernel(
            q, k, v, cache_len, scale, causal, longest), flush, clean=True),
        plain_ms=time_ms(lambda: A._ref_attention_cache(
            q, k, v, cache_len, scale, causal), flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), flush),
        bound_ms=b_ms, bound_by=b_by,
        launch=decode_launch(A, resources, q, C, longest=longest))
    if sweep:
        rec.update(split_sweeps(A, lambda s: A.decode_attention_kernel(
            q, k, v, cache_len, scale, causal, _splits=s), flush, C, sweep))
    emit(phase="kernels", kernel="decode_attention", **rec)
    return rec


def decode_width_check(A, dev, gen, dtype, d):
    """Untimed: the dense and paged decode kernels at a key row of
    d * itemsize bytes that is not a power of two of 16-byte pieces, not
    a multiple of 16 bytes (element-by-element copies), longer than 512
    bytes (2 or 4 pieces a lane) or than 2048 (the output's columns in
    2048-byte chunks, one block each), on unpadded caches, against the plain
    version; ragged lengths, a wrapped ring; then ``attention_with_cache``
    on the same cache with its rows padded to 16 bytes, as the sessions
    allocate them, against the unpadded result."""
    B, H, C, ptok = 8, 4, 320, 64
    q, k, v = (torch.randn(*s, device=dev, generator=gen).to(dtype)
               for s in ((B, H, 1, d), (B, H, C, d), (B, H, C, d)))
    cache_len = torch.tensor([1, 2, 63, 64, 65, 299, 320, 777],
                             dtype=torch.int32, device=dev)
    n0 = (A.decode_attention_kernel.launches,
          A.paged_attention_kernel.launches)
    got = A.attention_with_cache(q, k, v, cache_len)
    want = A._ref_attention_cache(q, k, v, cache_len, d ** -0.5)
    table = torch.arange(B * C // ptok, dtype=torch.int32,
                         device=dev).view(B, C // ptok)
    pools = [t.view(B, H, C // ptok, ptok, d).permute(0, 2, 1, 3, 4)
             .reshape(B * C // ptok, H, ptok, d).contiguous() for t in (k, v)]
    paged = A.paged_attention_cache(q, *pools, table, cache_len)
    width = A.decode_row_width(d, dtype)
    padded = A.attention_with_cache(q, *(F.pad(t, (0, width - d))
                                         for t in (k, v)), cache_len)
    torch.cuda.synchronize()
    if (A.decode_attention_kernel.launches - n0[0],
            A.paged_attention_kernel.launches - n0[1]) != (2, 1):
        raise AssertionError("decode d %d %s: the kernels were not launched"
                             % (d, dtype))
    err = (got.float() - want.float()).abs().max().item()
    err_paged = (paged.float() - got.float()).abs().max().item()
    err_padded = (padded.float() - got.float()).abs().max().item()
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    if not (err <= atol and err_paged <= PAGED_VS_DENSE_ATOL and
            err_padded <= atol):
        raise AssertionError(
            "decode d %d %s: kernel vs plain max |err| %g (> %g?), paged vs "
            "dense %g (> %g?), padded rows vs unpadded %g" % (
                d, dtype, err, atol, err_paged, PAGED_VS_DENSE_ATOL,
                err_padded))
    rec = dict(d=d, dtype=str(dtype), row_bytes=d * q.element_size(),
               padded_row_bytes=width * q.element_size(),
               lanes_and_pieces=A.decode_lanes(d * q.element_size()),
               column_chunks=A.decode_chunks(d * q.element_size()),
               max_abs_err=err, paged_vs_dense=err_paged,
               padded_vs_unpadded=err_padded, atol=atol)
    emit(phase="kernels", kernel="decode_attention_width", **rec)
    return rec


def paged_case(A, dev, gen, flush, name, B, npages, pool_pages, lens,
               timed=True, resources=None, sweep=()):
    """The paged kernel, 16 heads of 64 in pages of 128 tokens (the
    serving path's geometry, ``paged_inputs``), against the plain version
    and the dense kernel on the gathered cache (the same pieces and
    tiles: equal to PAGED_VS_DENSE_ATOL)."""
    H, d, ptok = 16, 64, 128
    q, k_pool, v_pool, table, cache_len = paged_inputs(
        dev, gen, B, npages, pool_pages, lens)
    scale = 1.0 / math.sqrt(d)
    longest = max(lens)     # as the paged session holds it on the host
    got = A.paged_attention_kernel(q, k_pool, v_pool, table, cache_len,
                                   scale, longest)
    kd, vd = (A.gather_paged_cache(p, table).contiguous()
              for p in (k_pool, v_pool))
    want = A._ref_attention_cache(q, kd, vd, cache_len, scale)
    dense = A.decode_attention_kernel(q, kd, vd, cache_len, scale,
                                      longest=longest)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_dense = (got - dense).abs().max().item()
    if not (err <= FP32_ATOL and err_dense <= PAGED_VS_DENSE_ATOL):
        raise AssertionError("%s: paged kernel vs plain %g (> %g?), vs dense "
                             "kernel %g (> %g?)" % (name, err, FP32_ATOL,
                                                    err_dense,
                                                    PAGED_VS_DENSE_ATOL))
    rec = dict(name=name, B=B, H=H, ptok=ptok, npages=npages,
               pool_pages=pool_pages, d=d, lens=lens, max_abs_err=err,
               max_abs_err_vs_dense=err_dense, atol=FP32_ATOL)
    if not timed:
        return rec
    cap = npages * ptok
    live = sum(min(n, cap) for n in lens)
    b_ms, b_by = bound(q, live, 4 * B + 4 * B * npages)
    rec.update(
        kernel_ms=time_ms(lambda: A.paged_attention_kernel(
            q, k_pool, v_pool, table, cache_len, scale, longest), flush),
        kernel_ms_clean_l2=time_ms(lambda: A.paged_attention_kernel(
            q, k_pool, v_pool, table, cache_len, scale, longest), flush,
            clean=True),
        plain_ms=time_ms(lambda: A._ref_attention_cache(
            q, A.gather_paged_cache(k_pool, table),
            A.gather_paged_cache(v_pool, table), cache_len, scale), flush),
        dense_kernel_ms=time_ms(lambda: A.decode_attention_kernel(
            q, kd, vd, cache_len, scale, longest=longest), flush),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        launch=decode_launch(A, resources, q, cap, npages, longest))
    if sweep:
        rec.update(split_sweeps(A, lambda s: A.paged_attention_kernel(
            q, k_pool, v_pool, table, cache_len, scale, _splits=s), flush,
            cap, sweep))
    emit(phase="kernels", kernel="paged_attention", **rec)
    return rec


# the decode kernel cases of the kernels phase: (name, function, arguments
# after (A, dev, gen, flush), keywords); timed, each case times itself
def decode_case_list():
    path_lens = np.random.RandomState(2).randint(64, 97, 64).tolist()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            ("path_" + tag, dense_case, ("path_" + tag, 64, 16, 1, 1024, 64,
                                         path_lens, dtype),
             dict(sweep=(1, 2)) if dtype == torch.float32 else {}),
            ("ragged_" + tag, dense_case, (
                "ragged_" + tag, 64, 16, 1, 1000, 64,
                np.random.RandomState(3).randint(1, 1001, 64).tolist(),
                dtype), {}),
            ("causal_" + tag, dense_case, (
                "causal_" + tag, 64, 16, 4, 1024, 64,
                [2, 3, 4, 5] + list(range(64, 1024, 16)), dtype),
             dict(causal=True)),
            ("wrapped_" + tag, dense_case, (
                "wrapped_" + tag, 64, 16, 1, 1024, 64,
                list(range(1025, 1025 + 64 * 37, 37)), dtype), {})]
    # the speculative verify step: batch 8, k 4 under the causal window, at
    # lengths of the speculative phase's rounds (prompts of 64, up to 32
    # new tokens); untimed, lengths on both sides of the first piece's end
    # (128 columns), where a piece that stopped short of a row's window
    # would drop its keys
    cases += [
        ("verify_f32", dense_case, ("verify_f32", 8, 16, 4, 1024, 64,
                                    list(range(68, 100, 4)), torch.float32),
         dict(causal=True)),
        ("verify_boundary_f32", dense_case, (
            "verify_boundary_f32", 8, 16, 4, 1024, 64,
            list(range(125, 133)), torch.float32),
         dict(causal=True, timed=False))]
    for dtype, d in ((torch.bfloat16, 8), (torch.float32, 48),
                     (torch.bfloat16, 96), (torch.float16, 64),
                     (torch.float32, 6), (torch.bfloat16, 12),
                     (torch.float32, 192), (torch.float32, 512),
                     (torch.bfloat16, 512), (torch.float32, 640),
                     (torch.bfloat16, 1536)):
        cases.append(("width_%s_d%d" % (str(dtype)[6:], d),
                      decode_width_check, (dtype, d), {}))
    # the serving path: width 8, 8 pages a slot, a 25-page pool, five live
    # slots (one full, one across three pages) and three idle; the serving
    # phase's own steps (prompts of 32-64 tokens and up to 32 new ones:
    # every slot within its first page); then one long slot beside a
    # shorter one, 64 pages a slot
    cases += [
        ("paged_path", paged_case,
         ("paged_path", 8, 8, 25, [1024, 300, 96, 70, 65, 1, 1, 1]),
         dict(sweep=(1, 2, 3, 4, 8))),
        ("paged_step", paged_case,
         ("paged_step", 8, 8, 25,
          np.random.RandomState(5).randint(33, 97, 8).tolist()),
         dict(sweep=(1, 2, 4, 8))),
        ("paged_long", paged_case, ("paged_long", 2, 64, 89, [8192, 3000]),
         dict(sweep=(4, 8, 16, 32, 64)))]
    return cases


def decode_cases(A, dev, gen, flush, timed=True, resources=None):
    """Run every decode kernel case; {name: record}."""
    out = {}
    for name, fn, args, kw in decode_case_list():
        if fn is decode_width_check:
            out[name] = fn(A, dev, gen, *args)
        elif timed and kw.get("timed", True):
            out[name] = fn(A, dev, gen, flush, *args, resources=resources,
                           **kw)
        else:
            kw = {k: v for k, v in kw.items() if k not in ("sweep", "timed")}
            out[name] = fn(A, dev, gen, flush, *args, timed=False, **kw)
            if timed:       # a case left untimed in a timed run
                emit(phase="kernels", kernel="decode_attention",
                     **out[name])
    return out


def fused_bound(q, bias, backward, peak=FUSED_PEAK_OPS_PER_S):
    """(bound_ms, bound_by) of fused attention on q [B, H, S, d]: the
    bytes each input is read and each output written once (forward: q,
    k, v, bias, o, lse; backward: q, k, v, o, dO, lse, bias, dq, dk, dv,
    dbias) over the HBM rate, against the operations (forward 4 B H S^2 d:
    q.k^T and p.v; backward 10 B H S^2 d: q.k^T again, dO.v^T, dV, dK and
    dQ) at ``peak`` for the input type (FUSED_PEAK_OPS_PER_S: fp32 as
    3xTF32; PEAK_OPS_PER_S gives fp32 on the SIMT cores)."""
    B, H, S, d = q.shape
    n, e = q.numel(), q.element_size()
    if backward:
        nbytes = 8 * n * e + 4 * B * H * S + 2 * 4 * bias.numel()
        ops = 10.0 * B * H * S * S * d
    else:
        nbytes = 4 * n * e + 4 * B * H * S + 4 * bias.numel()
        ops = 4.0 * B * H * S * S * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_case(A, dev, gen, flush, name, B, H, S, d, bias_shape, p, dtype):
    """The fused training-attention kernels against the plain version on
    the same inputs and seed: forward output, and dq, dk, dv, dbias of
    one random upstream gradient. ``bias_shape`` "padding" is BERT's
    [B, 1, 1, S] mask (0 on the first len_b keys, -1e4 after them, lengths
    S/2..S), else a random bias of that shape. Times the forward kernel,
    the two backward kernels together, the plain version (autograd for its
    backward) and SDPA with the same float mask at p = 0."""
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    if bias_shape == "padding":
        lens = torch.randint(S // 2, S + 1, (B, 1), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                           -1e4).view(B, 1, 1, S)
    else:
        bias = torch.randn(*bias_shape, device=dev, generator=gen)
    seed = torch.tensor([7919 * S + d], dtype=torch.int64, device=dev)
    scale = d ** -0.5
    bias_f, strides = A._bias_operand(bias, B, H, S)

    def forward():
        return A.fused_attention_fwd_kernel(q, k, v, bias_f, strides, seed,
                                            scale, p)

    o, lse = forward()

    def backward():
        return A.fused_attention_backward(q, k, v, bias_f, strides, seed, o,
                                          lse, do, scale, p, bias_grad=True)

    got = (o,) + tuple(backward())
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v,
                                                                 bias)]
    ref = A._ref_fused_attention(*leaves, scale, p, seed)
    want = (ref.detach(),) + tuple(torch.autograd.grad(ref, leaves, do,
                                                       retain_graph=True))
    torch.cuda.synchronize()
    errs = {}
    for key, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        limit = FUSED_ATOL[dtype] * max(1.0, b.float().abs().max().item())
        if not err <= limit:
            raise AssertionError("%s: fused attention %s kernel vs plain "
                                 "max |err| %g > %g" % (name, key, err,
                                                        limit))
        errs[key] = err
    mask = bias.to(dtype)
    lib_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask,
                                             scale=scale)
    f_ms, f_by = fused_bound(q, bias, False)
    b_ms, b_by = fused_bound(q, bias, True)
    extra = {}
    if dtype == torch.float32:
        # the bound at the SIMT cores' rate, the kernels SDPA runs, and
        # SDPA's own distance from the plain version at p 0 (TF32 alone
        # would read about 1e-3 of max(1, the largest magnitude))
        plain_p0 = A._ref_fused_attention(q, k, v, bias, scale, 0.0, seed)
        extra = dict(
            library_rel_err=((lib_out.detach() - plain_p0).abs().max() /
                             max(1.0, plain_p0.abs().max().item())).item(),
            bound_simt_ms={kind: fused_bound(q, bias, kind == "bwd",
                                             PEAK_OPS_PER_S)[0]
                           for kind in ("fwd", "bwd")},
            library_kernels=dict(
                fwd=device_kernels(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)),
                bwd=device_kernels(lambda: torch.autograd.grad(
                    lib_out, lib_leaves, do, retain_graph=True))))
    rec = dict(
        name=name, B=B, H=H, S=S, d=d, dtype=str(dtype),
        bias=list(bias.shape), dropout=p, max_abs_err=errs,
        fwd=dict(
            max_abs_err=errs["out"],
            kernel_ms=time_ms(forward, flush),
            plain_ms=time_ms(lambda: A._ref_fused_attention(
                q, k, v, bias, scale, p, seed), flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), flush),
            bound_ms=f_ms, bound_by=f_by),
        bwd=dict(
            max_abs_err=max(errs[x] for x in ("dq", "dk", "dv", "dbias")),
            kernel_ms=time_ms(backward, flush),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                ref, leaves, do, retain_graph=True), flush),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, do, retain_graph=True), flush),
            library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask,
                                               scale=scale),
                lib_leaves, do), flush),
            bound_ms=b_ms, bound_by=b_by), **extra)
    for kind in ("fwd", "bwd"):
        rec[kind]["tflops"] = achieved_tflops(q, kind, rec[kind]["kernel_ms"])
    emit(phase="kernels", kernel="fused_attention", **rec)
    return rec


# The TPU package's training tiers (paddle_tpu/kernels/attention.py), by
# which the summary line names the TPU kernel each launch of the one CUDA
# family stands in for: _fwd_kernel/_bwd_kernel up to S 1024, the long
# kernels up to S 4096 where _long_qb finds a query tile, the flash kernels
# past that; in the packed layout the resident kernels (S <= 1024, heads
# in pairs of 128 lanes, a batch block in VMEM), else the packed kernels
# (S <= 256), else the per-head tiers after a transpose.
TPU_MAX_FUSED_SEQ, TPU_MAX_LONG_SEQ, TPU_PACKED_MAX_SEQ = 1024, 4096, 256
MIB = 1024 * 1024


def long_qb(S, d):
    """The TPU package's query tile for its long kernels: 128 or 64 rows
    whose VMEM footprint estimate stays under 13 MB, else None."""
    for qb in (128, 64):
        if S % qb == 0 and 7.5 * qb * S * 4 + 24 * S * d <= 13 * 1024 * 1024:
            return qb
    return None


def _largest_divisor(B, fits):
    best = None
    for bb in range(1, B + 1):
        if B % bb == 0 and fits(bb):
            best = bb
    return best


def res_blocks(B, S, HD, itemsize):
    """The TPU package's resident batch block (``_res_blocks``): the
    largest divisor of B whose six double-buffered [Bb, S, H*d] blocks
    and ten [Bb, S, S] fp32 temporaries fit 13 MB, else None."""
    return _largest_divisor(B, lambda bb: 6 * bb * S * HD * itemsize * 2 +
                            10 * bb * S * S * 4 <= 13 * MIB)


def packed_hc(H, S):
    """The TPU package's packed-tier head chunk (``_packed_hc``)."""
    return next((hc for hc in range(H, 0, -1)
                 if H % hc == 0 and 22 * hc * S * S * 4 <= 8 * MIB), None)


def packed_bb(B, S, HD, H):
    """The TPU package's packed-tier batch block (``_packed_bb``)."""
    if packed_hc(H, S) is None:
        return None
    return _largest_divisor(B, lambda bb: 42 * bb * S * HD + 8 * MIB <=
                            15 * MIB)


def reference_tier(S, d, packed=None):
    """The TPU package tier whose kernels a launch at sequence length S
    and head width d stands in for: "fused", "long" or "flash" for
    [B, H, S, d] operands; with ``packed`` = (B, H, itemsize, bias shape)
    for the packed [B, S, H*d] entry, "resident" or "packed" (a copy of
    ``_use_res_kernel`` and ``_use_packed_kernel``), else the per-head
    tier that entry falls back to."""
    if packed is not None:
        B, H, itemsize, bias_shape = packed
        bias_ok = bias_shape[2] == 1 and bias_shape[1] in (1, H)
        if S <= TPU_MAX_FUSED_SEQ and H % 2 == 0 and (2 * d) % 128 == 0 \
                and res_blocks(B, S, H * d, itemsize) and bias_ok:
            return "resident"
        if S <= TPU_PACKED_MAX_SEQ and packed_bb(B, S, H * d, H) \
                and bias_ok:
            return "packed"
    if S <= TPU_MAX_FUSED_SEQ:
        return "fused"
    if S <= TPU_MAX_LONG_SEQ and long_qb(S, d) is not None:
        return "long"
    return "flash"


def long_bound(q, bias, kind):
    """(bound_ms, bound_by) of one kernel of the long-sequence family on
    q [B, H, S, d]: ``kind`` "fwd" (q, k, v, bias in; o, lse out; q.k^T
    and p.v, 4 B H S^2 d), "dq" (q, k, v, o, dO, lse, bias in; dq, delta
    out; q.k^T, dO.v^T and dS.K, 6 B H S^2 d) or "dkdv" (q, k, v, dO,
    lse, delta, bias in; dk, dv, dbias out; q.k^T, dO.v^T, P^T.dO and
    dS^T.Q, 8 B H S^2 d), or "bwd" for the whole backward as in
    ``fused_bound``."""
    if kind in ("fwd", "bwd"):
        return fused_bound(q, bias, kind == "bwd")
    B, H, S, d = q.shape
    n, e, rows = q.numel(), q.element_size(), 4 * B * H * S
    if kind == "dq":
        nbytes, ops = 6 * n * e + 2 * rows + 4 * bias.numel(), 6.0
    else:
        nbytes, ops = 6 * n * e + 2 * rows + 2 * 4 * bias.numel(), 8.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * B * H * S * S * d / FUSED_PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the products each kernel computes, in units of B*H*S^2*d operations:
# the forward 4 (q.k^T, p.v), dq 6 (q.k^T and dO.v^T again, dS.k), dk/dv
# 8 (q.k^T and dO.v^T again, P^T.dO, dS^T.q), the backward pair 14
KERNEL_UNITS = {"fwd": 4, "dq": 6, "dkdv": 8, "bwd": 14}


def achieved_tflops(q, kind, ms):
    """TFLOP/s of kernel ``kind`` on q [B, H, S, d] in ``ms``, counted
    on the work it does (KERNEL_UNITS)."""
    B, H, S, d = q.shape
    return KERNEL_UNITS[kind] * B * H * S * S * d / (ms * 1e-3) / 1e12


LONG_OUTPUTS = ("out", "lse", "dq", "dk", "dv", "dbias")
# what a backward kernel's library_ms times: no PyTorch call computes dq
# or dk/dv alone, so each carries the SDPA backward of the pair
LIBRARY_OF = {"dq": "SDPA backward of the dq + dk/dv pair",
              "dkdv": "SDPA backward of the dq + dk/dv pair",
              "bwd": "SDPA backward"}
# The kernels past S 1024 against the plain version: each output's
# max |kernel - plain| as a share of the plain output's own largest
# magnitude, held to a limit per output and type that lies between the
# readings of the sound kernels and of planted faults on the H100
# (tools/attention_fault_check.py; PERF.md). Largest sound readings over
# the cases: fp32 4.1e-6 (out), 2.0e-7 (lse), 9.6e-7 (gradients); bf16,
# whose outputs both sides round to bf16, 2.5e-3 (out), 4.0e-3 (dq),
# 3.3e-3 (dk), 2.3e-3 (dv), 4.0e-4 (dbias, fp32). Smallest fault
# readings: 2.2e-3 (lse, one 64-key tile skipped at S 8192), 9.9e-2
# (dbias), 0.22 or more for the rest.
LONG_RTOL = {
    torch.float32: dict(out=1e-4, lse=1e-5, dq=1e-4, dk=1e-4, dv=1e-4,
                        dbias=1e-4),
    torch.bfloat16: dict(out=1e-2, lse=1e-5, dq=1e-2, dk=1e-2, dv=1e-2,
                         dbias=1e-2)}
# float16 runs the same kernels as bfloat16 with three more mantissa
# bits: bf16's limits hold it
LONG_RTOL[torch.float16] = LONG_RTOL[torch.bfloat16]


def long_case_list():
    """Every long-sequence kernel case as (name, B, H, S, bias_shape, p,
    dtype, backward, by_pair): batch 1 with the full 12 heads of 64 at
    S 2048, 4096 and 8192, p = 0, fp32 and bf16; at S 2048 dropout 0.1
    and a per-row [1, 12, S, S] bias; then bf16 with dropout 0.1 at each
    shape of the bert_long phase (S 2048 x 8, 4096 x 4, 8192 x 2), the
    last one held to the plain version one (batch, head) pair at a time,
    whose [B, H, S, S] tensors would not fit the card whole."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for S in (2048, 4096, 8192):
            cases.append(("S%d_%s" % (S, tag), 1, 12, S, "padding", 0.0,
                          dtype, True, False))
        cases.append(("S2048_dropout_" + tag, 1, 12, 2048, "padding", 0.1,
                      dtype, True, False))
        cases.append(("S2048_bias_1x12xSxS_" + tag, 1, 12, 2048,
                      (1, 12, 2048, 2048), 0.0, dtype, True, False))
    for S, B in ((2048, 8), (4096, 4), (8192, 2)):
        cases.append(("S%d_batch%d_dropout_bf16" % (S, B), B, 12, S,
                      "padding", 0.1, torch.bfloat16, True, S == 8192))
    return cases


def long_plain(A, q, k, v, do, bias, seed, scale, p, backward, first_pair=0):
    """{output: tensor} of the plain version: the forward, the row
    logsumexp of the biased fp32 scores and, with ``backward``, autograd's
    dq, dk, dv and dbias for the upstream gradient ``do``."""
    leaves = [t.detach().clone().requires_grad_(backward)
              for t in (q, k, v, bias)]
    o = A._ref_fused_attention(*leaves, scale, p, seed, first_pair)
    want = {"lse": torch.logsumexp(A._ref_scores(q, k, bias, scale), dim=-1)}
    if backward:
        want.update(zip(("dq", "dk", "dv", "dbias"),
                        torch.autograd.grad(o, leaves, do)))
    want["out"] = o.detach()
    return want


def long_check(A, dev, name, B, H, S, bias_shape, p, dtype, backward=True,
               by_pair=False):
    """The kernels past S 1024 (d 64) against the plain version on the
    same inputs and seed: flash_attention's output and row logsumexp, and
    flash_attention_backward's dq, dk, dv, dbias of one random upstream
    gradient. ``bias_shape`` as ``fused_case``. ``by_pair`` runs the plain
    version one (batch, head) pair at a time with that pair's dropout
    mask, and sums its bias gradients over the pairs that share a bias
    row. The inputs come from a generator seeded by the case, so every
    run of a case sees the same data. Returns (record, inputs): the
    record holds each output's max |err|, the plain output's largest
    magnitude, their ratio and its limit; nothing is raised here."""
    d = 64
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    if bias_shape == "padding":
        lens = torch.randint(S // 2, S + 1, (B, 1), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                           -1e4).view(B, 1, 1, S)
    else:
        bias = torch.randn(*bias_shape, device=dev, generator=gen)
    seed = torch.tensor([7919 * S + B], dtype=torch.int64, device=dev)
    scale = d ** -0.5
    o, lse = A.flash_attention(q, k, v, bias, scale, p, seed)
    got = {"out": o, "lse": lse}
    if backward:
        got.update(zip(("dq", "dk", "dv", "dbias"),
                       A.flash_attention_backward(q, k, v, bias, seed, do, o,
                                                  lse, scale, p)))
    err = dict.fromkeys(got, 0.0)
    ref = dict.fromkeys(got, 0.0)

    def compare(key, a, b):
        err[key] = max(err[key], (a.float() - b.float()).abs().max().item())
        ref[key] = max(ref[key], b.float().abs().max().item())

    if not by_pair:
        want = long_plain(A, q, k, v, do, bias, seed, scale, p, backward)
        for key in got:
            compare(key, got[key], want[key])
        del want
    else:
        dbias = torch.zeros_like(got["dbias"]) if backward else None
        for b in range(B):
            for h in range(H):
                one = [t[b:b + 1, h:h + 1] for t in (q, k, v, do)]
                bb, bh = (b if bias.shape[0] > 1 else 0,
                          h if bias.shape[1] > 1 else 0)
                want = long_plain(A, *one, bias[bb:bb + 1, bh:bh + 1], seed,
                                  scale, p, backward, first_pair=b * H + h)
                for key in got:
                    if key != "dbias":
                        compare(key, got[key][b:b + 1, h:h + 1], want[key])
                if backward:
                    dbias[bb:bb + 1, bh:bh + 1] += want["dbias"].float()
                del want
        if backward:
            compare("dbias", got["dbias"], dbias)
    rtol = LONG_RTOL[dtype]
    rec = dict(name=name, B=B, H=H, S=S, d=d, dtype=str(dtype),
               bias=list(bias.shape), dropout=p, by_pair=by_pair,
               tier=reference_tier(S, d), max_abs_err=err, ref_max_abs=ref,
               rel_err={key: err[key] / ref[key] for key in err},
               rtol={key: rtol[key] for key in err})
    del got
    return rec, (q, k, v, do, bias, seed, scale, p, o, lse)


def long_case(A, dev, flush, case, timed):
    """One long-sequence case (``long_case_list``): held to its limits,
    then with ``timed`` the forward kernel, the dq kernel and the dk/dv
    kernel alone and together, the plain version (autograd for its
    backward) and SDPA with the same float mask at p = 0."""
    name, B, H, S, bias_shape, p, dtype, backward, by_pair = case
    rec, (q, k, v, do, bias, seed, scale, p, o, lse) = long_check(
        A, dev, name, B, H, S, bias_shape, p, dtype, backward, by_pair)
    for key, rel in rec["rel_err"].items():
        if not rel <= rec["rtol"][key]:
            raise AssertionError(
                "%s: long attention %s kernel vs plain max |err| %g = %g of "
                "the plain's largest magnitude > %g" % (
                    name, key, rec["max_abs_err"][key], rel,
                    rec["rtol"][key]))
    if timed:
        bias_f, strides = A._bias_operand(bias, B, H, S)
        f_ms, f_by = long_bound(q, bias, "fwd")
        rec["fwd"] = dict(
            kernel_ms=time_ms(lambda: A.fused_attention_fwd_kernel(
                q, k, v, bias_f, strides, seed, scale, p), flush),
            plain_ms=time_ms(lambda: A._ref_fused_attention(
                q, k, v, bias, scale, p, seed), flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias.to(dtype), scale=scale), flush),
            bound_ms=f_ms, bound_by=f_by,
            max_abs_err=max(rec["max_abs_err"][x] for x in ("out", "lse")))
        rec["fwd"]["tflops"] = achieved_tflops(q, "fwd",
                                               rec["fwd"]["kernel_ms"])
    if timed and backward:
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        ref = A._ref_fused_attention(*leaves, scale, p, seed)
        _, delta = A.fused_attention_bwd_dq_kernel(
            q, k, v, bias_f, strides, seed, o, lse, do, scale, p)
        dbias_shape = (B, H if strides[1] else 1, S if strides[2] else 1, S)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *lib_leaves, attn_mask=bias.to(dtype), scale=scale)
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            ref, leaves, do, retain_graph=True), flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, do, retain_graph=True), flush)
        errs = {"dq": ("dq",), "dkdv": ("dk", "dv", "dbias"),
                "bwd": ("dq", "dk", "dv", "dbias")}
        for kind, fn in (
                ("dq", lambda: A.fused_attention_bwd_dq_kernel(
                    q, k, v, bias_f, strides, seed, o, lse, do, scale, p)),
                ("dkdv", lambda: A.fused_attention_bwd_dkdv_kernel(
                    q, k, v, bias_f, strides, seed, lse, delta, do, scale,
                    p, dbias_shape)),
                ("bwd", lambda: A.flash_attention_backward(
                    q, k, v, bias, seed, do, o, lse, scale, p))):
            b_ms, b_by = long_bound(q, bias, kind)
            # dq and dk/dv carry the SDPA backward's time of the pair
            rec[kind] = dict(
                kernel_ms=time_ms(fn, flush), plain_ms=plain_bwd,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd,
                library_of=LIBRARY_OF[kind],
                max_abs_err=max(rec["max_abs_err"][x] for x in errs[kind]))
            rec[kind]["tflops"] = achieved_tflops(q, kind,
                                                  rec[kind]["kernel_ms"])
        rec["bwd"]["library_bwd_of_both_halves_ms"] = lib_bwd
        del ref, leaves, lib_out, lib_leaves
    emit(phase="kernels", kernel="long_attention", **rec)
    del q, k, v, do, bias, o, lse
    torch.cuda.empty_cache()
    return rec


def long_cases(A, dev, flush):
    """Every long-sequence case, the batch-1 ones timed; returns the bf16
    records at S 2048 (the long tier's path length) and S 8192 (the flash
    tier's), p = 0, which the summary line reports."""
    recs = {}
    for case in long_case_list():
        recs[case[0]] = long_case(A, dev, flush, case, timed=case[1] == 1)
    return recs["S2048_bf16"], recs["S8192_bf16"]


def packed_case_list():
    """Every packed-layout kernel case as (name, B, S, H, d, bias_shape,
    p, dtype, timed), fp32 and bf16: BERT-base at batch 128, S 128 (the
    bert_packed path, where the TPU runs its resident tier) with the
    padding mask [B, 1, 1, S] and with a per-head bias [B, 12, 1, S];
    BERT-tiny at the same batch and S (4 heads of 16, the padding mask:
    the bert_packed path's BERT-tiny run, where the TPU runs its packed
    tier); each at p 0 timed and at p 0.1 untimed; and, untimed, batch
    8, S 256, 3 heads of 64 with a per-head bias, where the odd H fails
    the resident gate and the TPU runs its packed tier."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, H, d, heads in (("resident_bcast", 12, 64, 1),
                                  ("resident_heads", 12, 64, 12),
                                  ("tiny_path", 4, 16, 1)):
            for p in (0.0, 0.1):
                cases.append(("%s%s_%s" % (name, "_dropout" if p else "",
                                           tag), 128, 128, H, d,
                              (128, heads, 1, 128), p, dtype, p == 0.0))
        cases.append(("odd_heads_" + tag, 8, 256, 3, 64, (8, 3, 1, 256),
                      0.0, dtype, False))
    return cases


def packed_check(A, dev, name, B, S, H, d, bias_shape, p, dtype, salt=0):
    """The kernels on packed [B, S, H*d] operands, read through the heads'
    [B, H, S, d] views (strides S*H*d, d, H*d), against the plain version
    on the same inputs and seed: the forward's output and row logsumexp,
    and the backward's dq, dk, dv and dbias of one random upstream
    gradient. The bias is a padding mask (lengths S/2..S) plus, for a
    per-head shape, a random term per head. The inputs come from a
    generator seeded by the case and ``salt`` (0 in chip_smoke; others
    give the spread of the readings over data and dropout masks).
    Returns (record, inputs) as ``long_check``; raises nothing."""
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(name.encode()) + salt)
    q, k, v, do = (A._split_heads(torch.randn(B, S, H * d, device=dev,
                                              generator=gen).to(dtype), H)
                   for _ in range(4))
    lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    if bias_shape[1] > 1:
        bias = bias + torch.randn(*bias_shape, device=dev, generator=gen)
    seed = torch.tensor([7919 * S + B + salt], dtype=torch.int64,
                        device=dev)
    scale = d ** -0.5
    bias_f, strides = A._bias_operand(bias, B, H, S)
    o, lse = A.fused_attention_fwd_kernel(q, k, v, bias_f, strides, seed,
                                          scale, p)
    got = dict(zip(LONG_OUTPUTS, (o, lse) + A.fused_attention_backward(
        q, k, v, bias_f, strides, seed, o, lse, do, scale, p,
        bias_grad=True)))
    if not all(got[key].stride() == q.stride()
               for key in ("out", "dq", "dk", "dv")):
        raise AssertionError("%s: the kernels' outputs left the packed "
                             "layout: %s" % (name, {
                                 key: got[key].stride() for key in got}))
    want = long_plain(A, q, k, v, do, bias, seed, scale, p, True)
    err = {key: (got[key].float() - want[key].float()).abs().max().item()
           for key in LONG_OUTPUTS}
    ref = {key: want[key].float().abs().max().item() for key in LONG_OUTPUTS}
    rtol = LONG_RTOL[dtype]
    rec = dict(name=name, B=B, S=S, H=H, d=d, dtype=str(dtype),
               bias=list(bias.shape), dropout=p,
               tier=reference_tier(S, d, (B, H, q.element_size(),
                                          bias.shape)), salt=salt,
               max_abs_err=err, ref_max_abs=ref,
               rel_err={key: err[key] / ref[key] for key in err},
               rtol={key: rtol[key] for key in err})
    del got, want
    return rec, (q, k, v, do, bias, bias_f, strides, seed, scale, o, lse)


def packed_case(A, dev, flush, case):
    """One packed-layout case (``packed_case_list``): held to its limits
    (LONG_RTOL), then when timed the forward kernel, the dq kernel and the
    dk/dv kernel alone and together on the heads' views, the plain
    version (autograd for its backward), and SDPA on the heads' views with
    the same float mask at p = 0, its layout copies counted (it returns
    the packed [B, S, H*d] output, as the kernels do). Bounds as
    ``long_bound`` on the [B, H, S, d] view: at S 128 the bytes bound
    both directions."""
    name, B, S, H, d, bias_shape, p, dtype, timed = case
    rec, (q, k, v, do, bias, bias_f, strides, seed, scale, o, lse) = \
        packed_check(A, dev, name, B, S, H, d, bias_shape, p, dtype)
    for key, rel in rec["rel_err"].items():
        if not rel <= rec["rtol"][key]:
            raise AssertionError(
                "%s: packed attention %s kernel vs plain max |err| %g = %g "
                "of the plain's largest magnitude > %g" % (
                    name, key, rec["max_abs_err"][key], rel,
                    rec["rtol"][key]))
    if timed:
        mask = bias.to(dtype)
        packed = [A._merge_heads(t) for t in (q, k, v)]

        def library(q_, k_, v_):
            return A._merge_heads(F.scaled_dot_product_attention(
                *(A._split_heads(t, H) for t in (q_, k_, v_)),
                attn_mask=mask, scale=scale))

        f_ms, f_by = long_bound(q, bias, "fwd")
        rec["fwd"] = dict(
            kernel_ms=time_ms(lambda: A.fused_attention_fwd_kernel(
                q, k, v, bias_f, strides, seed, scale, p), flush),
            plain_ms=time_ms(lambda: A._ref_fused_attention_packed(
                *packed, bias, H, scale, p, seed), flush),
            library_ms=time_ms(lambda: library(*packed), flush),
            bound_ms=f_ms, bound_by=f_by,
            max_abs_err=max(rec["max_abs_err"][x] for x in ("out", "lse")))
        rec["fwd"]["tflops"] = achieved_tflops(q, "fwd",
                                               rec["fwd"]["kernel_ms"])
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in packed + [bias]]
        ref = A._ref_fused_attention_packed(*leaves, H, scale, p, seed)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in packed]
        lib_out = library(*lib_leaves)
        do_packed = A._merge_heads(do)
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            ref, leaves, do_packed, retain_graph=True), flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, do_packed, retain_graph=True), flush)
        _, delta = A.fused_attention_bwd_dq_kernel(
            q, k, v, bias_f, strides, seed, o, lse, do, scale, p)
        dbias_shape = (B, bias_shape[1], 1, S)
        errs = {"dq": ("dq",), "dkdv": ("dk", "dv", "dbias"),
                "bwd": ("dq", "dk", "dv", "dbias")}
        for kind, fn in (
                ("dq", lambda: A.fused_attention_bwd_dq_kernel(
                    q, k, v, bias_f, strides, seed, o, lse, do, scale, p)),
                ("dkdv", lambda: A.fused_attention_bwd_dkdv_kernel(
                    q, k, v, bias_f, strides, seed, lse, delta, do, scale,
                    p, dbias_shape)),
                ("bwd", lambda: A.fused_attention_backward(
                    q, k, v, bias_f, strides, seed, o, lse, do, scale, p,
                    bias_grad=True))):
            b_ms, b_by = long_bound(q, bias, kind)
            # dq and dk/dv carry the SDPA backward's time of the pair
            rec[kind] = dict(
                kernel_ms=time_ms(fn, flush), plain_ms=plain_bwd,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd,
                library_of=LIBRARY_OF[kind],
                max_abs_err=max(rec["max_abs_err"][x] for x in errs[kind]))
            rec[kind]["tflops"] = achieved_tflops(q, kind,
                                                  rec[kind]["kernel_ms"])
        rec["bwd"]["library_bwd_of_both_halves_ms"] = lib_bwd
        del ref, leaves, lib_out, lib_leaves, packed
    emit(phase="kernels", kernel="packed_attention", **rec)
    del q, k, v, do, bias, o, lse
    torch.cuda.empty_cache()
    return rec


def packed_cases(A, dev, flush):
    """Every packed-layout case; returns the timed bf16 records at the
    bert_packed path's two shapes, BERT-base (the TPU's resident tier)
    and BERT-tiny (its packed tier), which the summary line reports."""
    recs = {}
    for case in packed_case_list():
        recs[case[0]] = packed_case(A, dev, flush, case)
    return recs["resident_bcast_bf16"], recs["tiny_path_bf16"]


def packed_equals_per_head(A, dev):
    """The packed entry (the kernels on the heads' strided views) and
    fused_attention on contiguous transposed copies of the operands at
    p 0.1 with one seed (BERT-base's heads, batch 16, S 128, padding
    mask): out, dq, dk and dv equal to the last bit, dbias (summed over
    heads by fp32 atomics in the order blocks finish) within 1e-6 of its
    largest magnitude."""
    B, S, H, d, p = 16, 128, 12, 64, 0.1
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do = (torch.randn(B, S, H * d, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    seed = torch.tensor([4242], dtype=torch.int64, device=dev)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, do))

    packed = run(lambda q_, k_, v_, b_: A.fused_attention_packed(
        q_, k_, v_, b_, n_heads=H, dropout_prob=p, seed=seed))
    heads = run(lambda q_, k_, v_, b_: A._merge_heads(A.fused_attention(
        *(A._split_heads(t, H).contiguous() for t in (q_, k_, v_)), b_,
        dropout_prob=p, seed=seed)))
    torch.cuda.synchronize()
    equal = {key: bool(torch.equal(a, b)) for key, a, b in
             zip(("out", "dq", "dk", "dv"), packed, heads)}
    dbias_rel = ((packed[4] - heads[4]).abs().max() /
                 heads[4].abs().max()).item()
    if not (all(equal.values()) and dbias_rel <= 1e-6):
        raise AssertionError("packed vs per-head at p %g: bit-equal %s, "
                             "dbias rel %g (> 1e-6?)" % (p, equal,
                                                         dbias_rel))
    emit(phase="kernels", kernel="packed_vs_per_head", B=B, S=S, H=H, d=d,
         dropout=p, bit_equal=equal, dbias_rel=dbias_rel)


def width_case(A, dev, name, B, H, S, d, p, dtype):
    """Untimed: ``fused_attention`` (the entry every route takes, which
    zero-pads a head width the kernels are not built for) forward and
    backward against the plain version, padding mask, each output held
    to LONG_RTOL relative to the plain output's largest magnitude."""
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    q, k, v, do = (torch.randn(B, H, S, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    lens = torch.randint(S // 2, S + 1, (B, 1), device=dev, generator=gen)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens, 0.0,
                       -1e4).view(B, 1, 1, S)
    seed = torch.tensor([7919 * S + d], dtype=torch.int64, device=dev)
    got, want = [], []
    for fn, out in ((lambda *t: A.fused_attention(
            *t, dropout_prob=p, seed=seed), got),
            (lambda *t: A._ref_fused_attention(*t, d ** -0.5, p, seed),
             want)):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        o = fn(*leaves)
        out.extend([o.detach()] + list(torch.autograd.grad(o, leaves, do)))
    torch.cuda.synchronize()
    rtol = LONG_RTOL[dtype]
    rel = {}
    for key, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        rel[key] = ((a.float() - b.float()).abs().max() /
                    b.float().abs().max()).item()
        if not rel[key] <= rtol[key]:
            raise AssertionError("%s: fused attention %s kernel vs plain "
                                 "%g of the plain's largest magnitude > %g"
                                 % (name, key, rel[key], rtol[key]))
    emit(phase="kernels", kernel="fused_attention_width", name=name, B=B,
         H=H, S=S, d=d, built_width=A.built_width(d),
         column_chunks=A.column_chunks(d), dtype=str(dtype), dropout=p,
         rel_err=rel, rtol=rtol)


def fused_cases(A, dev, gen, flush):
    """Every case of the fused kernels; returns the BERT path's fp32
    records at dropout 0.1 and 0, which the summary line reports. fp32
    runs on the tensor cores as 3xTF32 up to d 128. Untimed, head widths
    the kernels reach zero-padded (48, 80, 160), built at d 256 (the
    SIMT forward in every type, the backward's outputs in two column
    halves on the tensor cores, 32-row tiles in fp32) and past 256 (d 320
    and 512: the outputs' columns in 64-column chunks, one block each) in
    fp32, bf16 and fp16, and fp16 at the BERT path's shape."""
    path = path_p0 = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        rec = fused_case(A, dev, gen, flush, "path_" + tag, 32, 12, 512, 64,
                         "padding", 0.1, dtype)
        path = path or rec
        rec = fused_case(A, dev, gen, flush, "path_p0_" + tag, 32, 12, 512,
                         64, "padding", 0.0, dtype)
        path_p0 = path_p0 or rec
        for bias_shape in ((4, 12, 1, 256), (4, 1, 256, 256),
                           (4, 12, 256, 256)):
            fused_case(A, dev, gen, flush, "bias_%s_%s" % (
                "x".join(map(str, bias_shape[1:3])), tag), 4, 12, 256, 64,
                bias_shape, 0.1, dtype)
        fused_case(A, dev, gen, flush, "ragged_" + tag, 8, 12, 500, 64,
                   "padding", 0.1, dtype)
        fused_case(A, dev, gen, flush, "d128_" + tag, 8, 8, 512, 128,
                   "padding", 0.1, dtype)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                       (torch.float16, "f16")):
        width_case(A, dev, "d48_" + tag, 4, 16, 512, 48, 0.1, dtype)
        width_case(A, dev, "d80_" + tag, 4, 8, 384, 80, 0.0, dtype)
        width_case(A, dev, "d160_" + tag, 2, 4, 300, 160, 0.1, dtype)
        width_case(A, dev, "d256_" + tag, 2, 4, 520, 256, 0.0, dtype)
        width_case(A, dev, "d320_" + tag, 2, 4, 300, 320, 0.1, dtype)
        width_case(A, dev, "d512_" + tag, 2, 2, 260, 512, 0.0, dtype)
    for p in (0.0, 0.1):
        width_case(A, dev, "path_f16_p%g" % p, 32, 12, 512, 64, p,
                   torch.float16)
    return path, path_p0


FUSED_KERNELS = ("fused_attention_fwd_kernel", "fused_attention_bwd_dq_kernel",
                 "fused_attention_bwd_dkdv_kernel")
# each fused wrapper's launches that ran on the tensor cores (fp32 as
# 3xTF32, bfloat16 and float16 by their own products; up to d 128, the
# 16-bit backward also at d 256)
TENSOR_CORES = tuple(name + ":tensor_cores" for name in FUSED_KERNELS)
FWD_TC, DQ_TC, DKDV_TC = TENSOR_CORES


def reset_launches(A):
    A.decode_attention_kernel.launches = 0
    A.paged_attention_kernel.launches = 0
    for name in FUSED_KERNELS:
        getattr(A, name).launches = 0
        getattr(A, name).tensor_core_launches = 0


def launches(A, names):
    """{wrapper: launches} of ``names`` and, for each fused wrapper among
    them, {wrapper:tensor_cores: its launches on the tensor cores}."""
    got = {name: getattr(A, name).launches for name in names}
    for name, tc in zip(FUSED_KERNELS, TENSOR_CORES):
        if name in names:
            got[tc] = getattr(A, name).tensor_core_launches
    return got


# The fused wrappers' kernels by name (csrc/fused_attention.cu). A wrapper
# counts only the launches it makes; a CUDA graph's replay launches the
# kernels it captured without calling a wrapper, so a graphed window's
# replays are counted here, by name, in a torch.profiler trace.
KERNEL_NAME = re.compile(
    r"(?<!\w)attn_(fwd|bwd_dq|bwd_dkdv)(_mma|_tf32x3|_wide)?[<(]")
KERNEL_WRAPPER = dict(zip(("fwd", "bwd_dq", "bwd_dkdv"), FUSED_KERNELS))


def traced_launches(kern):
    """The fused kernels of a trace (``kernel_times``' {name: (us,
    calls)}), in the form of ``launches``: {wrapper: kernels of it,
    wrapper:tensor_cores: those on the tensor cores (_mma, _tf32x3)}."""
    got = dict.fromkeys(FUSED_KERNELS + TENSOR_CORES, 0)
    for key, (_, calls) in kern.items():
        m = KERNEL_NAME.search(key)
        if m:
            got[KERNEL_WRAPPER[m.group(1)]] += calls
            if m.group(2) in ("_mma", "_tf32x3"):
                got[KERNEL_WRAPPER[m.group(1)] + ":tensor_cores"] += calls
    return got


def traced_replay(exe, run, phase, **where):
    """More ``run()``s of a graphed window, traced (``complete_trace``):
    the fused kernels that ran (``traced_launches``), or None when
    ``exe`` runs eagerly (its wrappers counted every launch). Emits the
    device kernels each trace recorded."""
    if not exe.cuda_graphs:
        return None
    _, kern, totals, diffs = complete_trace(run)
    emit(phase=phase, check="replay_trace", kernels_per_trace=totals,
         trace_diffs=diffs, **where)
    return traced_launches(kern)


@contextlib.contextmanager
def plain_attention(T, A):
    """Route the model's dense decode attention through the plain
    version (the whole-model kernel-vs-plain step comparison)."""
    def plain(q, k, v, cache_len, scale=None, causal_window=False,
              longest=None):
        return A._ref_attention_cache(q, k, v, cache_len, scale,
                                      causal_window)

    saved, T.attention_with_cache = T.attention_with_cache, plain
    try:
        yield
    finally:
        T.attention_with_cache = saved


def dense_path(T, A, inference, monitor, dev):
    B, SRC, PROMPT, CAP, NEW = 64, 128, 64, 1024, 32
    model = T.Transformer.big(device=dev, seed=0)
    pred = inference.GenerativePredictor(
        model, batch_size=B, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, device=dev)
    rng = np.random.RandomState(0)
    src = rng.randint(2, 32000, (B, SRC)).astype(np.int64)
    prompt = rng.randint(2, 32000, (B, PROMPT)).astype(np.int64)
    plens = rng.randint(PROMPT // 2, PROMPT + 1, B).astype(np.int64)
    feed = {"src": src, "prompt": prompt, "prompt_lens": plens}
    pred.run(feed, max_new_tokens=2)                      # warm-up
    t0 = time.perf_counter()
    pred.run(feed, max_new_tokens=1)                      # prefill only
    t_prefill = time.perf_counter() - t0

    steps0 = monitor.counter("decode_steps_total").value
    reset_launches(A)
    t0 = time.perf_counter()
    tokens, finished = pred.run(feed, max_new_tokens=NEW)
    t_full = time.perf_counter() - t0
    launches = A.decode_attention_kernel.launches
    paged_launches = A.paged_attention_kernel.launches
    steps = monitor.counter("decode_steps_total").value - steps0
    L = len(model.dec_layers)
    if steps != NEW - 1 or launches != L * steps or paged_launches:
        raise AssertionError(
            "dense path: %d decode-kernel launches over %d steps (want %d "
            "per step), %d paged launches" % (launches, steps, L,
                                              paged_launches))
    if tokens.shape != (B, NEW) or tokens.dtype != np.int64 or \
            tokens.min() < 0 or tokens.max() >= 32000:
        raise AssertionError("dense path: bad tokens %s %s"
                             % (tokens.shape, tokens.dtype))
    again, _ = pred.run(feed, max_new_tokens=NEW)
    if not np.array_equal(again, tokens):
        raise AssertionError("dense path: generation is not deterministic")

    # one whole-model decode step, kernels vs plain versions, from the
    # same prefilled state
    sess = pred._session
    with torch.no_grad():
        caches = [torch.zeros_like(c) for c in sess._caches]
        outs = model.prefill(
            torch.from_numpy(src).to(dev), torch.from_numpy(prompt).to(dev),
            sess._pos_src, sess._pos_tgt, sess._causal,
            torch.zeros(B, dtype=torch.int32, device=dev), *caches)
        cross = outs[1 + 2 * L:1 + 4 * L]
        tok = torch.from_numpy(tokens[:, :1].astype(np.int32)).to(dev)
        fin = torch.zeros(B, 1, dtype=torch.bool, device=dev)
        lens = torch.from_numpy(plens.astype(np.int32)).to(dev)
        logits = {}
        for route, ctx in (("kernel", contextlib.nullcontext()),
                           ("plain", plain_attention(T, A))):
            state = [c.clone() for c in caches]
            captured = []
            hook = model.proj.register_forward_hook(
                lambda m, i, o: captured.append(o))
            try:
                with ctx:
                    model.decode_step(tok, fin, sess._end_ids, lens,
                                      *cross, *state)
            finally:
                hook.remove()
            logits[route] = captured[0]
        torch.cuda.synchronize()
    step_err = (logits["kernel"] - logits["plain"]).abs().max().item()
    if not (torch.isfinite(logits["kernel"]).all() and
            step_err <= STEP_LOGITS_ATOL):
        raise AssertionError("dense path: decode-step logits kernel vs "
                             "plain max |err| %g > %g"
                             % (step_err, STEP_LOGITS_ATOL))
    emit(phase="dense", batch=B, src_len=SRC, prompt_len=PROMPT,
         cache_capacity=CAP, new_tokens=NEW, decode_steps=steps,
         decode_kernel_launches=launches, launches_per_step=launches / steps,
         prefill_s=t_prefill, generate_s=t_full,
         step_ms=(t_full - t_prefill) / (NEW - 1) * 1e3,
         tokens_per_s=B * NEW / t_full,
         decode_tokens_per_s=B * (NEW - 1) / (t_full - t_prefill),
         finished=int(finished.sum()), step_logits_max_abs_err=step_err,
         step_logits_atol=STEP_LOGITS_ATOL,
         step_logits_max_abs=logits["plain"].abs().max().item())
    return pred, launches, feed


def serving_path(T, A, inference, monitor, dev, dense_pred, dense_feed):
    W, SRC, PROMPT, CAP = 8, 128, 64, 1024
    model = dense_pred._session.model
    pred = inference.GenerativePredictor(
        model, batch_size=W, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, paged=True, page_tokens=128, pool_pages=25,
        prefix_cache_size=8, device=dev)
    # 16 requests over 10 distinct (src, prompt) pairs: rows of the dense
    # path's batch, so the dense session's tokens are the yardstick
    rng = np.random.RandomState(1)
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 3, 5, 0, 8, 3]
    budgets = rng.randint(8, 33, len(rows)).tolist()
    src, prompt, plens = (dense_feed[k] for k in ("src", "prompt",
                                                  "prompt_lens"))
    results, latency = [None] * len(rows), [None] * len(rows)
    hits0 = monitor.counter("decode_prefix_hit_total").value
    steps0 = monitor.counter("decode_steps_total").value
    occ = monitor.histogram("serving_batch_occupancy",
                            labels={"model": "smoke"})
    occ0 = (occ.sum, occ.count)
    reset_launches(A)
    t0 = time.perf_counter()
    with inference.GenerativeServer(pred.open_stream(), model="smoke") as srv:
        def client(k):
            # submit this client's requests back to back, then poll them:
            # a request's latency is submit -> its future resolving
            pending = {}
            for j in range(k, len(rows), 4):
                i = rows[j]
                pending[j] = (time.perf_counter(), srv.submit(
                    src[i], prompt[i], prompt_len=int(plens[i]),
                    max_new_tokens=budgets[j]))
            while pending:
                for j, (ts, fut) in list(pending.items()):
                    if fut.done():
                        latency[j] = time.perf_counter() - ts
                        results[j] = fut.result()
                        del pending[j]
                time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("serving client thread hung")
    wall = time.perf_counter() - t0
    launches = A.paged_attention_kernel.launches
    dense_launches = A.decode_attention_kernel.launches
    steps = monitor.counter("decode_steps_total").value - steps0
    hits = monitor.counter("decode_prefix_hit_total").value - hits0
    if any(r is None for r in results):
        raise AssertionError("serving: unresolved futures")
    if not (launches > 0 and launches == len(model.dec_layers) * steps
            and dense_launches == 0 and hits > 0):
        raise AssertionError(
            "serving: %d paged launches over %d steps, %d dense launches, "
            "%d prefix hits" % (launches, steps, dense_launches, hits))
    for (tok, fin), budget in zip(results, budgets):
        if tok.dtype != np.int64 or not 1 <= len(tok) <= budget or \
                tok.min() < 0 or tok.max() >= 32000:
            raise AssertionError("serving: bad tokens %r" % (tok,))
    dense_tokens, _ = dense_pred.run(dense_feed, max_new_tokens=max(budgets))
    agree = sum(np.array_equal(tok, dense_tokens[i, :len(tok)])
                for (tok, _), i in zip(results, rows))
    lat = np.array(latency)
    emit(phase="serving", width=W, page_tokens=128, pool_pages=25,
         prefix_cache_size=8, requests=len(rows), distinct=len(set(rows)),
         wall_s=wall, decode_steps=steps, paged_kernel_launches=launches,
         launches_per_step=launches / steps, prefix_hits=hits,
         request_p50_s=float(np.percentile(lat, 50)),
         request_p99_s=float(np.percentile(lat, 99)),
         occupancy_mean=(occ.sum - occ0[0]) / (occ.count - occ0[1]),
         tokens_served=int(sum(len(t) for t, _ in results)),
         agree_with_dense=agree)
    return launches


# -- the dense continuous stream and speculative decoding ---------------------
# bench.py's decode-engine legs (bench_decode_engine): Transformer.big, src
# 128, prompt 64, ring 1024; a stream of width 8; speculative at batch 8,
# k 4, full prompts, 12 and 32 new tokens, with the default draft depth
# (L // 2) and the full-depth draft (every proposal accepted).
STREAM_WIDTH, STREAM_REQUESTS = 8, 16
SPEC_BATCH, SPEC_K, SPEC_NEW = 8, 4, (12, 32)
TRACED_STEPS = 8


def stream_drive(stream, reqs, step_s=None):
    """Requests ``reqs`` [(src, prompt, prompt_len, budget)] through
    ``stream`` in order: join into vacant slots, step, until every one
    completed. {index: (tokens, finished)}; each step's host seconds
    (the step ends in its one sync) appended to ``step_s``."""
    pending, slot_of, done = list(range(len(reqs))), {}, {}
    while pending or stream.active_count:
        while pending and stream.vacant_slots():
            i = pending.pop(0)
            src, prompt, plen, budget = reqs[i]
            slot, out = stream.join(src, prompt, prompt_len=plen,
                                    max_new_tokens=budget)
            if out is None:
                slot_of[slot] = i
            else:
                done[i] = out
        if stream.active_count:
            t0 = time.perf_counter()
            completed = stream.step()
            if step_s is not None:
                step_s.append(time.perf_counter() - t0)
            for slot, toks, fin in completed:
                done[slot_of.pop(slot)] = (toks, fin)
    return done


def drain(stream):
    """Step ``stream`` until every slot retired."""
    while stream.active_count:
        stream.step()


@contextlib.contextmanager
def proj_logits(model, keep):
    """Hold each output of ``model.proj`` for which ``keep(out)`` is true
    (the logits of the steps run inside)."""
    got = []
    hook = model.proj.register_forward_hook(
        lambda m, i, o: got.append(o) if keep(o) else None)
    try:
        yield got
    finally:
        hook.remove()


def kernel_vs_plain_logits(T, A, model, run):
    """max |kernel - plain| and max |plain| of the logits of ``run()`` (one
    step from cloned state), run with the decode kernel and with the
    plain version, and the plain logits."""
    logits = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_attention(T, A))):
        with ctx, proj_logits(model, lambda o: True) as got, \
                torch.no_grad():
            run()
        logits[route] = got[-1]
    torch.cuda.synchronize()
    if not torch.isfinite(logits["kernel"]).all():
        raise AssertionError("non-finite kernel logits")
    return ((logits["kernel"] - logits["plain"]).abs().max().item(),
            logits["plain"].abs().max().item(), logits["plain"])


def stream_step_check(T, A, stream, reqs):
    """One stream step with the slots at mixed lengths and some idle:
    three requests of different prompt lengths joined, two steps, then
    the third step run from cloned state with the kernel and with the
    plain version; the stream is drained after."""
    s = stream._s
    for src, prompt, plen, _ in reqs[:3]:
        stream.join(src, prompt, prompt_len=plen, max_new_tokens=32)
    stream.step()
    stream.step()
    stream._clamp_idle()
    hlen = stream._hlen.copy()

    def run():
        s.model.decode_step(
            stream._tok, stream._fin, s._end_ids, stream._len,
            *stream._cross, *[c.clone() for c in stream._kc + stream._vc],
            longest=int(hlen.max()) + 1)

    err, peak, _ = kernel_vs_plain_logits(T, A, s.model, run)
    if not err <= STEP_LOGITS_ATOL:
        raise AssertionError("stream: step logits kernel vs plain max |err| "
                             "%g > %g" % (err, STEP_LOGITS_ATOL))
    live = stream.active_count
    drain(stream)
    return dict(step_logits_max_abs_err=err,
                step_logits_atol=STEP_LOGITS_ATOL, step_logits_max_abs=peak,
                step_live_slots=live, step_lengths=hlen.tolist())


def scatter_kernels(T, stream):
    """(tensors, the host's launch calls, the device kernels {name:
    calls}) of one join's slot scatter at the stream's shapes, into an
    idle slot from batch-1 zeros, from the fullest of TRACE_TRIES traces
    (``complete_trace``)."""
    state = stream._kc + stream._vc + stream._cross
    rows = [torch.zeros_like(t[:1]) for t in state]
    slot = stream.vacant_slots()[0]
    T._slot_scatter(state, rows, slot)
    api, kern, _, _ = complete_trace(
        lambda: T._slot_scatter(state, rows, slot))
    return len(state), api, {k[:120]: n for k, (_, n) in kern.items()
                             } or "not measured"


def idle_share(step_ms, fn, steps):
    """{busy ms, idle share, device kernels, host launch calls} a step of
    ``steps`` steps run by ``fn`` in one trace, against ``step_ms``, the
    untraced median step."""
    api, kern = host_launches(fn)
    if not kern:
        return dict(device_busy_ms="not measured", idle_share="not measured")
    busy = sum(us for us, _ in kern.values()) / 1e3 / steps
    return dict(device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
                device_kernels=sum(n for _, n in kern.values()) / steps,
                host_launch_calls={k: v / steps for k, v in api.items()})


def serve_requests(inference, stream, reqs, model_name):
    """``reqs`` through a GenerativeServer over ``stream`` from 4 client
    threads; (results, latencies s)."""
    results, latency = [None] * len(reqs), [None] * len(reqs)
    with inference.GenerativeServer(stream, model=model_name) as srv:
        def client(k):
            pending = {}
            for j in range(k, len(reqs), 4):
                src, prompt, plen, budget = reqs[j]
                pending[j] = (time.perf_counter(), srv.submit(
                    src, prompt, prompt_len=plen, max_new_tokens=budget))
            while pending:
                for j, (ts, fut) in list(pending.items()):
                    if fut.done():
                        latency[j] = time.perf_counter() - ts
                        results[j] = fut.result()
                        del pending[j]
                time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("%s: client thread hung" % model_name)
    if any(r is None for r in results):
        raise AssertionError("%s: unresolved futures" % model_name)
    return results, latency


def stream_path(T, A, inference, monitor, dev, model):
    """The dense continuous stream (GenerativePredictor(slot_prefill=True)
    .open_stream()) at width 8: 16 requests of ragged prompt lengths and
    budgets, each equal to its solo run in the stream; the decode kernel
    L times a step, the paged kernel never; one step at mixed lengths
    with idle slots held to the plain version; then the same requests
    through GenerativeServer."""
    W, SRC, PROMPT, CAP = STREAM_WIDTH, 128, 64, 1024
    L = len(model.dec_layers)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(2, 32000, SRC).astype(np.int64),
             rng.randint(2, 32000, PROMPT).astype(np.int64),
             int(rng.randint(8, PROMPT + 1)), int(rng.randint(8, 33)))
            for _ in range(STREAM_REQUESTS)]

    def predictor(end_id):
        return inference.GenerativePredictor(
            model, batch_size=W, src_len=SRC, prompt_len=PROMPT,
            cache_capacity=CAP, end_id=end_id, slot_prefill=True,
            device=dev)

    # a probe run (also the warm-up) with an end_id no request emits;
    # then end_id is a token that one request alone emits, first past its
    # second token, so exactly one request ends on it, in a step
    probe_pred = predictor(1)
    probe = stream_drive(probe_pred.open_stream(), reqs)
    seen = collections.Counter(t for i in probe for t in set(probe[i][0]))
    end_id = next((int(t) for i in sorted(probe) for t in probe[i][0][2:]
                   if seen[t] == 1 and t not in probe[i][0][:2]), 1)
    check = stream_step_check(T, A, probe_pred.open_stream(), reqs)
    del probe_pred

    pred = predictor(end_id)
    stream = pred.open_stream()
    names = ("decode_steps_total", "decode_slot_join_total",
             "decode_slot_retire_total",
             "decode_slot_scatter_dispatch_total")
    before = {n: monitor.counter(n).value for n in names}
    occ = monitor.histogram("decode_slot_occupancy")
    occ0 = (occ.sum, occ.count)
    reset_launches(A)
    step_s = []
    t0 = time.perf_counter()
    together = stream_drive(stream, reqs, step_s)
    wall = time.perf_counter() - t0
    launches = A.decode_attention_kernel.launches
    paged = A.paged_attention_kernel.launches
    delta = {n: monitor.counter(n).value - before[n] for n in names}
    steps = delta["decode_steps_total"]
    if not (steps == len(step_s) and launches == L * steps and paged == 0):
        raise AssertionError(
            "stream: %d decode-kernel launches over %d steps (want %d a "
            "step), %d paged launches" % (launches, steps, L, paged))
    at_join = sum(len(t) == 1 for t, _ in together.values())
    decoding = delta["decode_slot_join_total"] - at_join
    if delta["decode_slot_scatter_dispatch_total"] != decoding:
        raise AssertionError("stream: %d scatters for %d decoding joins"
                             % (delta["decode_slot_scatter_dispatch_total"],
                                decoding))
    solo = [stream_drive(stream, [r])[0] for r in reqs]
    unequal = [i for i, (t, f) in enumerate(solo)
               if not (np.array_equal(together[i][0], t)
                       and together[i][1] == f)]
    for i, (tok, fin) in together.items():
        if tok.dtype != np.int64 or not 1 <= len(tok) <= reqs[i][3] or \
                tok.min() < 0 or tok.max() >= 32000 or \
                (len(tok) < reqs[i][3] and not fin):
            raise AssertionError("stream: bad tokens %r" % (tok,))
    if unequal:
        raise AssertionError("stream: requests %s differ from their solo "
                             "runs" % unequal)
    step_ms = statistics.median(step_s) * 1e3
    # traced after the timed steps: a trace slows the host's later launches
    n_state, scatter_api, scatter = scatter_kernels(T, stream)
    for src, prompt, plen, _ in reqs[:W]:
        stream.join(src, prompt, prompt_len=plen, max_new_tokens=32)
    traced = idle_share(
        step_ms, lambda: [stream.step() for _ in range(TRACED_STEPS)],
        TRACED_STEPS)
    drain(stream)

    steps0 = monitor.counter("decode_steps_total").value
    reset_launches(A)
    t0 = time.perf_counter()
    served, latency = serve_requests(inference, pred.open_stream(), reqs,
                                     "smoke-dense")
    server_wall = time.perf_counter() - t0
    server_steps = monitor.counter("decode_steps_total").value - steps0
    server_launches = A.decode_attention_kernel.launches
    if server_launches != L * server_steps or \
            A.paged_attention_kernel.launches:
        raise AssertionError("stream server: %d decode launches over %d "
                             "steps" % (server_launches, server_steps))
    server_unequal = [i for i, (t, f) in enumerate(served)
                      if not (np.array_equal(t, solo[i][0])
                              and f == solo[i][1])]
    if server_unequal:
        raise AssertionError("stream server: requests %s differ from their "
                             "solo runs" % server_unequal)
    lat = np.array(latency)
    emit(phase="stream", width=W, src_len=SRC, prompt_len=PROMPT,
         cache_capacity=CAP, requests=len(reqs), end_id=end_id,
         ended_on_end_id=sum(bool(f) for _, f in together.values()),
         completed_at_join=at_join, joins=delta["decode_slot_join_total"],
         retires=delta["decode_slot_retire_total"],
         scatters_per_decoding_join=(
             delta["decode_slot_scatter_dispatch_total"] / decoding),
         scatter_tensors=n_state, scatter_launch_calls=scatter_api,
         scatter_device_kernels=scatter,
         decode_steps=steps, wall_s=wall, step_ms_median=step_ms,
         step_ms_mean=statistics.mean(step_s) * 1e3,
         occupancy_mean=(occ.sum - occ0[0]) / (occ.count - occ0[1]),
         decode_kernel_launches=launches, launches_per_step=launches / steps,
         tokens_served=int(sum(len(t) for t, _ in together.values())),
         equal_to_solo=len(reqs) - len(unequal),
         traced_steps=TRACED_STEPS, traced_per_step=traced,
         server_wall_s=server_wall, server_steps=server_steps,
         server_launches_per_step=server_launches / server_steps,
         request_p50_s=float(np.percentile(lat, 50)),
         request_p99_s=float(np.percentile(lat, 99)),
         server_equal_to_solo=len(reqs) - len(server_unequal), **check)
    return launches


@contextlib.contextmanager
def counted_calls(obj, names):
    """{name: calls} of ``obj``'s methods ``names`` made inside."""
    counts = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for name in names:
        setattr(obj, name, wrap(name, getattr(obj, name)))
    try:
        yield counts
    finally:
        for name in names:
            delattr(obj, name)


def top2_gap(logits):
    """Top-two gap of each row of ``logits`` [..., V]."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def dense_gap(sess, src, prompt, plens, row, pos):
    """The dense session's top-two logit gap where it chose token ``pos``
    of ``row``: the prefill's logits at the row's last prompt position
    for token 0, decode step ``pos`` for the rest."""
    with proj_logits(sess.model, lambda o: True) as got:
        sess.generate(src, prompt, plens, pos + 1)
    out = got[0][row, int(plens[row]) - 1] if pos == 0 else got[pos][row, 0]
    return top2_gap(out).item()


def first_short_round(T, spec, src, prompt, plens, new):
    """(round, smallest top-two gap of its verify logits) of the first
    round of ``spec.generate`` that accepted fewer than k tokens in some
    row, or None."""
    short = []
    hist = T._M_SPEC_ACCEPT
    k = spec.k
    with counted_calls(spec._s.model, ("verify_step",)) as n, \
            proj_logits(spec._s.model, lambda o: o.shape[1] == k) as got:
        observe = hist.observe

        def note(a):
            if a < k:
                short.append(n["verify_step"] - 1)
            observe(a)

        hist.observe = note
        try:
            spec.generate(src, prompt, plens, new)
        finally:
            del hist.observe
    if not short:
        return None
    return short[0], top2_gap(got[short[0]]).min().item()


def speculative_path(T, A, inference, monitor, dev, model):
    """Greedy self-speculative decoding (build_speculative_session ->
    SpeculativeDecodeSession.generate) at batch 8, k 4, full prompts:
    draft depth L // 2 (the default) and L; tokens equal to the dense
    session's row by row (a row may differ only at a near-tie of the
    dense run, and only one); the verify step's logits, kernel against
    plain, from one prefilled state; rounds, acceptance, launches and
    tokens/s beside the dense session at the same batch."""
    B, SRC, PROMPT, CAP, K = SPEC_BATCH, 128, 64, 1024, SPEC_K
    L = len(model.dec_layers)
    pred = inference.GenerativePredictor(
        model, batch_size=B, src_len=SRC, prompt_len=PROMPT,
        cache_capacity=CAP, device=dev)
    sess = pred._session
    rng = np.random.RandomState(7)
    src = rng.randint(2, 32000, (B, SRC)).astype(np.int64)
    prompt = rng.randint(2, 32000, (B, PROMPT)).astype(np.int64)
    plens = np.full(B, PROMPT, np.int64)
    feed = {"src": src, "prompt": prompt, "prompt_lens": plens}
    dense = {n: pred.run(feed, max_new_tokens=n)[0] for n in SPEC_NEW}
    t0 = time.perf_counter()
    pred.run(feed, max_new_tokens=SPEC_NEW[-1])
    dense_wall = time.perf_counter() - t0

    # the verify step from the dense session's prefilled state: the dense
    # run's first k tokens at the prompts' lengths
    outs = sess._prefill(src, prompt, sess._caches)
    state, cross = outs[1:1 + 2 * L], outs[1 + 2 * L:1 + 4 * L]
    toks = torch.from_numpy(dense[SPEC_NEW[0]][:, :K].astype(
        np.int32)).to(dev)
    step_ids = torch.arange(K, dtype=torch.int32, device=dev).view(1, -1)
    tlen = torch.from_numpy(plens.astype(np.int32)).to(dev)
    verify_err, verify_peak, verify_logits = kernel_vs_plain_logits(
        T, A, model, lambda: model.verify_step(
            toks, step_ids, tlen, *cross, *[c.clone() for c in state],
            longest=int(plens.max()) + K))
    if not verify_err <= STEP_LOGITS_ATOL:
        raise AssertionError("speculative: verify logits kernel vs plain "
                             "max |err| %g > %g"
                             % (verify_err, STEP_LOGITS_ATOL))
    verify_greedy = verify_logits.argmax(-1).cpu().numpy()
    verify_equal = int((verify_greedy[:, :K - 1] ==
                        dense[SPEC_NEW[0]][:, 1:K]).sum())

    hist = monitor.histogram("decode_spec_accepted_tokens")
    drafts, ties, launch_counts = [], [], {}
    for Ld in (None, L):
        spec = T.build_speculative_session(model, sess, k=K,
                                           draft_layers=Ld)
        Ld = spec.draft_layers
        rec = dict(draft_layers=Ld)
        spec.generate(src, prompt, plens, SPEC_NEW[0])        # warm-up
        for new in SPEC_NEW:
            c0, s0 = hist.count, hist.sum
            with counted_calls(model, ("verify_step",
                                       "decode_step_draft")) as n:
                reset_launches(A)
                t0 = time.perf_counter()
                got, _ = spec.generate(src, prompt, plens, new)
                wall = time.perf_counter() - t0
            launches = A.decode_attention_kernel.launches
            rounds, draft_steps = n["verify_step"], n["decode_step_draft"]
            if launches != L * rounds + Ld * draft_steps or \
                    A.paged_attention_kernel.launches or not rounds:
                raise AssertionError(
                    "speculative: %d decode launches for %d verify and %d "
                    "draft steps" % (launches, rounds, draft_steps))
            launch_counts["draft"] = launch_counts.get("draft", 0) + \
                Ld * draft_steps
            launch_counts["verify"] = launch_counts.get("verify", 0) + \
                L * rounds
            for b in np.flatnonzero((got != dense[new]).any(axis=1)):
                pos = int(np.flatnonzero(got[b] != dense[new][b])[0])
                gap = dense_gap(sess, src, prompt, plens, int(b), pos)
                ties.append(dict(draft_layers=Ld, new_tokens=new, row=int(b),
                                 position=pos, dense_top2_gap=gap))
                if not gap < STEP_LOGITS_ATOL:
                    raise AssertionError(
                        "speculative: row %d differs from dense at token %d "
                        "(dense top-two gap %g)" % (b, pos, gap))
            rec[new] = dict(
                rounds=rounds, draft_steps=draft_steps,
                verify_launches_per_round=L, draft_launches_per_step=Ld,
                accepted_mean=(hist.sum - s0) / (hist.count - c0),
                wall_s=wall, tokens_per_s=B * new / wall,
                rows_equal_to_dense=int((got == dense[new]).all(
                    axis=1).sum()))
        if Ld == L and rec[SPEC_NEW[-1]]["accepted_mean"] != K:
            rec["first_short_round"] = first_short_round(
                T, spec, src, prompt, plens, SPEC_NEW[-1])
            if rec["first_short_round"] and \
                    not rec["first_short_round"][1] < STEP_LOGITS_ATOL:
                raise AssertionError("speculative: the full-depth draft "
                                     "missed k at %s" % (
                                         rec["first_short_round"],))
        new = SPEC_NEW[0]
        t0 = time.perf_counter()
        spec.generate(src, prompt, plens, new)
        untraced = time.perf_counter() - t0
        rec["traced_generate"] = idle_share(
            untraced * 1e3, lambda: spec.generate(src, prompt, plens, new),
            1)
        rec["traced_generate"]["new_tokens"] = new
        drafts.append(rec)
    if len(ties) > 1:
        raise AssertionError("speculative: %d rows differ from dense at "
                             "near-ties: %s" % (len(ties), ties))
    emit(phase="speculative", batch=B, src_len=SRC, prompt_len=PROMPT,
         cache_capacity=CAP, k=K, new_tokens=list(SPEC_NEW),
         dense_wall_s=dense_wall,
         dense_tokens_per_s=B * SPEC_NEW[-1] / dense_wall, drafts=drafts,
         ties=ties, verify_logits_max_abs_err=verify_err,
         verify_logits_atol=STEP_LOGITS_ATOL,
         verify_logits_max_abs=verify_peak,
         verify_greedy_equal_to_dense=verify_equal,
         verify_greedy_positions=B * (K - 1))
    return launch_counts


BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 6
# One BERT-base training step, kernels vs plain attention from the same
# cloned scope and generator (the same dropout masks), fp32 with TF32 off.
# Loss: relative difference. Gradients: the Adam first moments after the
# step, (1 - beta1) * grad, as a share of each tensor's largest
# magnitude. Only summation order differs; a wrong mask or bias term in
# one layer moves both by orders of magnitude more.
# Limits: about ten times the first reading on the H100 (loss identical
# to the last bit, gradients 6.0e-6; PERF.md), a few ulps for the loss.
BERT_LOSS_RTOL = 1e-6
BERT_GRAD_RTOL = 1e-4
BERT_WATCH = ("word_emb", "layer_0_attn_q.w_0", "layer_5_attn_k.w_0",
              "layer_11_ffn2.w_0", "mlm_out_bias")


def clone_scope(fluid, scope):
    """A copy of every tensor of ``scope`` and of its generator's state."""
    c = fluid.Scope()
    for n in scope.local_var_names():
        c.set_var(n, scope.find_var(n).clone())
    c.generator = torch.Generator(device=scope.generator.device)
    c.generator.set_state(scope.generator.get_state())
    return c


def route_step(fluid, exe, main, feed, loss, scope):
    """One step of a step check's route: ``main`` on ``feed`` from a
    clone of ``scope`` (its tensors and generator) through an executor on
    ``exe``'s place with capture off, so each route runs its own kernels
    or its plain version and never replays a graph the other route
    captured (tools/graph_fault_check.py plants the fault). Returns (the
    loss fetch, the clone)."""
    sc = clone_scope(fluid, scope)
    eager = fluid.Executor(exe.place, cuda_graphs=False)
    return eager.run(main, feed=feed, fetch_list=[loss], scope=sc)[0], sc


@contextlib.contextmanager
def plain_fused_attention(A):
    """Route the program's fused_multihead_attention ops through the plain
    version on the card (the whole-step kernel-vs-plain comparison)."""
    def plain(q, k, v, bias=None, scale=None, dropout_prob=0.0, seed=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return A._ref_fused_attention(q, k, v, bias, float(scale),
                                      float(dropout_prob), seed)

    saved, A.fused_attention = A.fused_attention, plain
    try:
        yield
    finally:
        A.fused_attention = saved


def bert_program(fluid, bert):
    """(cfg, main, startup, loss, build seconds) of the fp32 BERT-base
    pretraining program at BERT_SEQ."""
    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg,
                                                          seq_len=BERT_SEQ)
    return cfg, main, startup, loss, time.perf_counter() - t0


def bert_step_check(A, exe, fluid, prog, feed, scope):
    """One fp32 step of ``prog`` (``bert_program``) on ``feed`` with the
    fused kernels and one with the plain attention, each from a clone of
    ``scope`` (its tensors and generator): the record of the loss's
    relative difference and the watched first moments' (BERT_WATCH)
    against BERT_LOSS_RTOL and BERT_GRAD_RTOL, ``passes``, and the
    kernel step's ``launches`` (``launches``: the caller holds them to
    their route). Raises if the kernel step did not launch each fused
    kernel once a layer, or the plain step launched any."""
    cfg, main, _, loss, _ = prog
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_fused_attention(A))):
        reset_launches(A)
        with ctx:
            step_loss, sc = route_step(fluid, exe, main, feed, loss, scope)
        launched = launches(A, FUSED_KERNELS)
        if [launched[n] for n in FUSED_KERNELS] != [
                cfg.n_layers * (route == "kernel")] * 3:
            raise AssertionError("bert: the %s step launched the fused "
                                 "kernels %s times" % (route, launched))
        if route == "kernel":
            kernel_launches = launched
        res[route] = (float(step_loss[0]),
                      {n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH},
                      {n: sc.find_var(n) for n in BERT_WATCH})
        del sc
    loss_rel = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    grad_rel = {n: ((res["kernel"][1][n] - res["plain"][1][n]).abs().max() /
                    res["plain"][1][n].abs().max()).item()
                for n in BERT_WATCH}
    # parameter moves differ in units of the learning rate (the first Adam
    # step moves each entry by about lr, whatever its gradient)
    param_lr = max((res["kernel"][2][n] - res["plain"][2][n]).abs().max()
                   .item() for n in BERT_WATCH) / 1e-4
    return dict(loss_kernel=res["kernel"][0], loss_plain=res["plain"][0],
                loss_rel=loss_rel, loss_rtol=BERT_LOSS_RTOL,
                grad_rel=grad_rel, grad_rel_max=max(grad_rel.values()),
                grad_rtol=BERT_GRAD_RTOL, param_diff_in_lr=param_lr,
                passes=bool(math.isfinite(res["kernel"][0]) and
                            loss_rel <= BERT_LOSS_RTOL and
                            max(grad_rel.values()) <= BERT_GRAD_RTOL),
                launches=kernel_launches)


def bert_path(A, dev):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg, main, startup, loss, build_s = prog = bert_program(fluid, bert)
    ops = main.global_block().ops
    fused = [op for op in ops if op.type == "fused_multihead_attention"]
    if len(fused) != cfg.n_layers or any(
            op.attr("dropout_prob") != cfg.attn_dropout for op in fused):
        raise AssertionError("bert: %d fused attention ops (want %d with "
                             "dropout %g)" % (len(fused), cfg.n_layers,
                                              cfg.attn_dropout))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feed = bert.synthetic_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0)
    exe = fluid.Executor(dev)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0

    # one step with the kernels and one with the plain attention
    check = bert_step_check(A, exe, fluid, prog, feed, scope)
    if list(check["launches"].values()) != [cfg.n_layers] * 6:
        raise AssertionError("bert: the kernel step's launches %s (want %d "
                             "each, all on the tensor cores)"
                             % (check["launches"], cfg.n_layers))
    if not check["passes"]:
        raise AssertionError("bert: step kernel vs plain: loss %r vs %r "
                             "(rel %g > %g?), gradients rel %g (> %g?)"
                             % (check["loss_kernel"], check["loss_plain"],
                                check["loss_rel"], BERT_LOSS_RTOL,
                                check["grad_rel_max"], BERT_GRAD_RTOL))
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launches(A)
    # a warm run (its wrappers launch), then the capture of its graph
    # (launches nothing), then replays
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    losses, step_s = [], []
    for _ in range(BERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    replayed = traced_replay(exe, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope), "bert")
    got = launches(A, FUSED_KERNELS)
    if any(n != cfg.n_layers for n in list(got.values()) +
           list(replayed.values())):
        raise AssertionError("bert: fused kernel launches %s over the warm "
                             "step, %s in a traced replay (want %d each, "
                             "all on the tensor cores)"
                             % (got, replayed, cfg.n_layers))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError("bert: losses not finite and falling: %s"
                             % losses)
    steady = statistics.median(step_s[1:])
    emit(phase="bert", config="BertConfig.base", params=n_params,
         batch=BERT_BATCH, seq_len=BERT_SEQ, dropout=cfg.hidden_dropout,
         ops=len(ops), fused_attention_ops=len(fused), build_s=build_s,
         startup_s=startup_s, losses=losses, step_s=step_s,
         step_ms=steady * 1e3, tokens_per_s=BERT_BATCH * BERT_SEQ / steady,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=got, replay_launches=replayed, step_vs_plain=check)
    return got, replayed


LONG_SHAPES = ((2048, 8), (4096, 4), (8192, 2))   # bench.py bench_longseq
LONG_CHECK_SEQ, LONG_CHECK_BATCH, LONG_STEPS = 2048, 1, 4
# One bf16 AMP step, kernels vs plain attention from a cloned scope and
# generator (the same dropout masks), as the bert phase compares fp32,
# at each data seed of STEP_SEEDS. Both compute attention in fp32 from
# the same bf16 q, k, v and round their output to bf16, but they sum in
# another order, so an output that lies near a rounding boundary comes
# out one bf16 step (2^-8 relative) apart, and the bf16 products of the
# 12 layers below carry that on. The loss is judged over the seeds
# together (STEP_LOSS_MAX, STEP_LOSS_MEAN). Each watched tensor's Adam
# first moment, 0.1 of its gradient, is held at every seed to its own
# limit as a share of its largest magnitude, about five times its first
# reading on the H100 (tools/attention_fault_check.py, PERF.md): word_emb
# 1.1e-2, the query weight 1.3e-2 (0.16 with one k-tile skipped in every
# kernel), the last FFN weight 9.0e-3, the output bias 7.4e-5. The key
# weight stands apart at 2.7e-2 (0.14 with the tile skipped): its
# gradient passes through the softmax's Jacobian, which cancels most of
# it (the key bias's entirely), so the rounding differences of the layers
# above stand out. The path's batch pads nothing (its bias is 0), so this
# step cannot see a fault of the mask; the kernel cases with padding do.
LONG_GRAD_RTOL = {"word_emb": 6e-2, "layer_0_attn_q.w_0": 6e-2,
                  "layer_5_attn_k.w_0": 2 ** -3,
                  "layer_11_ffn2.w_0": 4.5e-2, "mlm_out_bias": 4e-4}


def long_program(fluid, bert, S):
    """(cfg, main, startup, loss, build seconds) of the AMP program."""
    t0 = time.perf_counter()
    cfg = bert.BertConfig.base()
    cfg.max_seq = S
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=S,
                                                          use_amp=True)
    return cfg, main, startup, loss, time.perf_counter() - t0


# The loss of the one-step checks (bert_long's and bert_packed's), read
# at data seeds 0-5 and judged together: the signed relative differences
# (kernel - plain) / plain, their largest magnitude under STEP_LOSS_MAX
# and the magnitude of their mean under the phase's STEP_LOSS_MEAN, the
# latter for a forward whose rounding leans to one side. A reading is set
# by which attention outputs land on the other side of a bf16 rounding
# boundary, so it scatters with the data: the check's earlier limit, 1e-5
# on one seed, failed the accepted SIMT forward at 4 of these 6 seeds.
# Readings of seeds 0-5 on the H100, 700 W, with the SIMT forward
# (tools/attention_fault_check.py --forward simt, PERF.md):
#   bert_long   +4.04e-6 +5.35e-6 -1.47e-6 -5.90e-6 -7.19e-6 +5.54e-6,
#               mean +6.0e-8 (spread 5.5e-6, so a mean of six 2.2e-6);
#   bert_packed -1.66e-6 +3.13e-6 -6.83e-5 +9.82e-5 -5.55e-5 -3.06e-5,
#               mean -9.1e-6 (spread 5.5e-5, a mean of six 2.3e-5).
# The planted faults' largest |reading| and mean, bert_packed: a skipped
# tile 9.98e-4 and +2.75e-4, no mask 3.49e-4 and -5.37e-5, the mask keyed
# on the head 3.37e-4 and -4.47e-5 (+1.78e-4 at seed 0, the smallest
# fault reading of the one-seed check), a row stride of d 8.6e-3 and
# +1.5e-3;
# bert_long (no padding, batch 1: the mask faults do not show) a skipped
# tile 3.7e-5, a row stride of d 2.8e-3; a transposed K in dq moves only
# the first moments. STEP_LOSS_MAX lies between the SIMT forward's 9.8e-5
# and the smallest fault reading, 1.78e-4; each STEP_LOSS_MEAN about six
# and two of its phase's standard errors of a six-seed mean. Every fault
# fails a first-moment limit in at least one phase; those limits are
# unchanged.
STEP_SEEDS = tuple(range(6))
STEP_LOSS_MAX = 1.7e-4
STEP_LOSS_MEAN = {"bert_long": 1.5e-5, "bert_packed": 4.5e-5}


def step_check_seeds(A, exe, fluid, bert, prog, check, seeds=STEP_SEEDS):
    """The records of the one-step check ``check`` (``long_step_check``
    or ``packed_step_check``) of ``prog`` at each data seed."""
    return [check(A, exe, fluid, bert, prog, data_seed=s) for s in seeds]


def step_verdict(records, grad_rtol, loss_mean, loss_max=STEP_LOSS_MAX):
    """The multi-seed step check's verdict on ``records`` (one per data
    seed, each with its signed loss reading ``loss_signed_rel``, its
    ``loss_kernel`` and its first moments' ``grad_rel``): the largest
    |reading| under ``loss_max``, |mean reading| under ``loss_mean`` (the
    phase's STEP_LOSS_MEAN), and every first moment under its limit in
    ``grad_rtol`` at every seed.
    Returns a dict with the readings, the limits, ``over`` (the limits
    passed: "loss_max", "loss_mean", "first_moments", "loss_not_finite")
    and ``passes``."""
    signed = [r["loss_signed_rel"] for r in records]
    worst = max(abs(x) for x in signed)
    mean = sum(signed) / len(signed)
    grads_over = {"%s@seed%d" % (n, r["data_seed"]): v for r in records
                  for n, v in r["grad_rel"].items() if not v <= grad_rtol[n]}
    over = [name for name, bad in (
        ("loss_not_finite", not all(math.isfinite(r["loss_kernel"])
                                    for r in records)),
        ("loss_max", not worst <= loss_max),
        ("loss_mean", not abs(mean) <= loss_mean),
        ("first_moments", bool(grads_over))) if bad]
    return dict(seeds=[r["data_seed"] for r in records],
                loss_signed_rel=signed, loss_max_abs=worst,
                loss_max=loss_max, loss_mean_rel=mean, loss_mean=loss_mean,
                grad_rel_max={n: max(r["grad_rel"][n] for r in records)
                              for n in grad_rtol},
                grad_rtol=grad_rtol, grads_over=grads_over, over=over,
                passes=not over)


def long_step_check(A, exe, fluid, bert, prog, data_seed=0):
    """One bf16 AMP step of ``prog`` (``long_program`` at LONG_CHECK_SEQ)
    on a batch of LONG_CHECK_BATCH with the kernels, and one with the
    plain attention, from one cloned scope and generator. Returns the
    record: the loss's signed relative difference and each watched
    tensor's first-moment difference as a share of its largest
    magnitude. Raises here only if a route launched the wrong kernels.
    ``data_seed`` seeds the synthetic batch (``step_check_seeds`` reads
    STEP_SEEDS)."""
    cfg, main, startup, loss, _ = prog
    feed = bert.synthetic_batch(cfg, LONG_CHECK_BATCH, LONG_CHECK_SEQ,
                                seed=data_seed)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_fused_attention(A))):
        reset_launches(A)
        with ctx:
            step_loss, sc = route_step(fluid, exe, main, feed, loss, scope)
        launched = [getattr(A, name).launches for name in FUSED_KERNELS]
        if launched != [cfg.n_layers * (route == "kernel")] * 3:
            raise AssertionError("bert_long: the %s step launched the fused "
                                 "kernels %s times" % (route, launched))
        res[route] = (float(step_loss[0]),
                      {n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH})
        del sc
    del scope
    grad_rel = {n: ((res["kernel"][1][n] - res["plain"][1][n]).abs().max() /
                    res["plain"][1][n].abs().max()).item()
                for n in BERT_WATCH}
    return dict(seq_len=LONG_CHECK_SEQ, batch=LONG_CHECK_BATCH,
                data_seed=data_seed, loss_kernel=res["kernel"][0],
                loss_plain=res["plain"][0],
                loss_signed_rel=(res["kernel"][0] - res["plain"][0]) /
                res["plain"][0], grad_rel=grad_rel)


def bert_long_path(A, dev):
    """The long-context AMP path; returns {tier: ({kernel: launches},
    {kernel: launches in a traced replay})} summed over every shape."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    exe = fluid.Executor(dev)
    # one step with the kernels and one with the plain attention, at each
    # data seed of STEP_SEEDS
    cfg, main, startup, loss, build_s = prog = long_program(fluid, bert,
                                                            LONG_CHECK_SEQ)
    rec = step_verdict(step_check_seeds(A, exe, fluid, bert, prog,
                                        long_step_check), LONG_GRAD_RTOL,
                       STEP_LOSS_MEAN["bert_long"])
    emit(phase="bert_long", check="step_vs_plain", seq_len=LONG_CHECK_SEQ,
         batch=LONG_CHECK_BATCH, **rec)
    if not rec["passes"]:
        raise AssertionError("bert_long: step kernel vs plain over data "
                             "seeds %s: past %s" % (rec["seeds"], rec["over"]))
    torch.cuda.empty_cache()

    tiers = {t: tuple(dict.fromkeys(FUSED_KERNELS + TENSOR_CORES, 0)
                      for _ in range(2)) for t in ("fused", "long", "flash")}
    for S, batch in LONG_SHAPES:
        if S != LONG_CHECK_SEQ:
            cfg, main, startup, loss, build_s = long_program(fluid, bert, S)
        ops = main.global_block().ops
        fused = [op for op in ops if op.type == "fused_multihead_attention"]
        casts = sum(op.type == "cast" for op in ops)
        if len(fused) != cfg.n_layers or not casts:
            raise AssertionError("bert_long S %d: %d fused attention ops, %d "
                                 "casts" % (S, len(fused), casts))
        feed = bert.synthetic_batch(cfg, batch, S, seed=0)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(A)
        # a warm run (its wrappers launch), then the capture of its graph
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0]) for _ in range(2)]
        torch.cuda.synchronize()
        step_s = []
        for _ in range(LONG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
        replayed = traced_replay(exe, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope), "bert_long",
            seq_len=S)
        tier = reference_tier(S, cfg.hidden // cfg.n_heads)
        got = launches(A, FUSED_KERNELS)
        if any(n != cfg.n_layers for n in list(got.values()) +
               list(replayed.values())):
            raise AssertionError(
                "bert_long S %d: fused kernel launches %s over the warm "
                "step, %s in a traced replay (want %d each, all on the "
                "tensor cores)" % (S, got, replayed, cfg.n_layers))
        if not (all(math.isfinite(x) for x in losses) and
                losses[-1] < losses[0]):
            raise AssertionError("bert_long S %d: losses not finite and "
                                 "falling: %s" % (S, losses))
        for name in got:
            tiers[tier][0][name] += got[name]
            tiers[tier][1][name] += replayed[name]
        steady = statistics.median(step_s)
        emit(phase="bert_long", config="BertConfig.base, max_seq %d" % S,
             amp="bf16", seq_len=S, batch=batch, dropout=cfg.hidden_dropout,
             masked_positions=bert.max_predictions(S), ops=len(ops),
             casts=casts, build_s=build_s, losses=losses, step_s=step_s,
             step_ms=steady * 1e3, tokens_per_s=batch * S / steady,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated()
             / 2 ** 30, tier=tier, launches=got, replay_launches=replayed)
        del scope, main, startup
        exe.close()         # no S 8192 graph pool outlives its shape
        torch.cuda.empty_cache()
    return tiers


PACKED_BATCH, PACKED_SEQ, PACKED_STEPS = 128, 128, 4   # bench.py bench_bert
PACKED_CHECK_BATCH, TIER_STEPS = 2, 2
# the three attention layouts of config 3 run in this order, each from a
# fresh scope, so a drift of the host's speed over the phase falls on
# all three alike: (label, use_fused_attention)
LAYOUT_ROUNDS = (("packed", "packed"), ("auto", "auto"), ("per_head", True),
                 ("per_head", True), ("auto", "auto"), ("packed", "packed"))
# One BERT-base AMP step at S 128 with the packed kernels against one
# with the plain packed attention, from a cloned scope and generator (the
# same dropout masks), batch 2, at each data seed of STEP_SEEDS, as
# long_step_check does at S 2048: the loss judged over the seeds
# together (STEP_LOSS_MAX, STEP_LOSS_MEAN), each watched tensor's Adam
# first moment as a share of its largest magnitude at every seed;
# bert_long's limits. First readings on the H100 (PERF.md): sound,
# word_emb 1.1e-2, the query weight 1.1e-2, the key weight 3.2e-2, the
# last FFN weight 8.3e-3, the output bias 1.8e-5; every planted fault (a
# skipped tile, no mask, the head-keyed dropout mask, a row stride of d)
# moves the query and key weights' moments by 0.11 or more. The second
# row is padded, so this step also sees faults of the mask.
PACKED_GRAD_RTOL = {"word_emb": 6e-2, "layer_0_attn_q.w_0": 6e-2,
                    "layer_5_attn_k.w_0": 2 ** -3,
                    "layer_11_ffn2.w_0": 4.5e-2, "mlm_out_bias": 4e-4}


def packed_program(fluid, bert, cfg, attention, seq=PACKED_SEQ):
    """(cfg, main, startup, loss, build seconds) of the AMP pretraining
    program with ``use_fused_attention=attention``."""
    t0 = time.perf_counter()
    cfg.max_seq = max(cfg.max_seq, seq)
    cfg.use_fused_attention = attention
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(cfg, seq_len=seq,
                                                          use_amp=True)
    return cfg, main, startup, loss, time.perf_counter() - t0


@contextlib.contextmanager
def plain_packed_attention(A):
    """Route the program's fused_multihead_attention_packed ops through
    the plain version on the card."""
    def plain(q, k, v, bias=None, n_heads=1, scale=None, dropout_prob=0.0,
              seed=None):
        d = q.shape[-1] // n_heads
        scale = d ** -0.5 if scale is None else scale
        return A._ref_fused_attention_packed(q, k, v, bias, n_heads,
                                             float(scale),
                                             float(dropout_prob), seed)

    saved, A.fused_attention_packed = A.fused_attention_packed, plain
    try:
        yield
    finally:
        A.fused_attention_packed = saved


def packed_step_check(A, exe, fluid, bert, prog, data_seed=0):
    """One bf16 AMP step of ``prog`` (``packed_program``, BERT-base) on a
    batch of PACKED_CHECK_BATCH at S 128 with the packed kernels, and one
    with the plain packed attention, from one cloned scope and generator.
    Returns the record (as ``long_step_check``); raises here only if a
    route launched the wrong kernels."""
    cfg, main, startup, loss, _ = prog
    feed = bert.synthetic_batch(cfg, PACKED_CHECK_BATCH, PACKED_SEQ,
                                seed=data_seed)
    # padding: the second row keeps 96 of its 128 tokens
    feed["input_mask"][1, 96:] = 0.0
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    res = {}
    for route, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", plain_packed_attention(A))):
        reset_launches(A)
        with ctx:
            step_loss, sc = route_step(fluid, exe, main, feed, loss, scope)
        launched = [getattr(A, name).launches for name in FUSED_KERNELS]
        if launched != [cfg.n_layers * (route == "kernel")] * 3:
            raise AssertionError("bert_packed: the %s step launched the "
                                 "kernels %s times" % (route, launched))
        res[route] = (float(step_loss[0]),
                      {n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH})
        del sc
    del scope
    grad_rel = {n: ((res["kernel"][1][n] - res["plain"][1][n]).abs().max() /
                    res["plain"][1][n].abs().max()).item()
                for n in BERT_WATCH}
    return dict(seq_len=PACKED_SEQ, batch=PACKED_CHECK_BATCH,
                data_seed=data_seed, loss_kernel=res["kernel"][0],
                loss_plain=res["plain"][0],
                loss_signed_rel=(res["kernel"][0] - res["plain"][0]) /
                res["plain"][0], grad_rel=grad_rel)


def timed_steps(A, exe, fluid, bert, prog, batch, steps):
    """Two warm steps (through a graphed ``exe``, the second captures the
    step) and ``steps`` timed steps of ``prog`` on one synthetic batch,
    in a fresh scope: (losses, step seconds, peak GB allocated from the
    first warm step on, the fused wrappers' launches from the first warm
    step on, the fused kernels of one more replay (``traced_replay``) or
    None when ``exe`` runs eagerly). Closes ``exe`` after, so no graph
    outlives its run."""
    cfg, main, startup, loss, _ = prog
    feed = bert.synthetic_batch(cfg, batch, PACKED_SEQ, seed=0)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A)
    # a warm run, then (graphed) the capture of its graph
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(2)]
    torch.cuda.synchronize()
    step_s = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    replayed = traced_replay(exe, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope), "timed_steps",
        attention=str(cfg.use_fused_attention))
    got = launches(A, FUSED_KERNELS)
    del scope
    exe.close()
    torch.cuda.empty_cache()
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError("bert_packed (%s): losses not finite and "
                             "falling: %s" % (cfg.use_fused_attention,
                                              losses))
    return losses, step_s, peak, got, replayed


def bert_packed_path(A, dev):
    """BASELINE config 3 in the packed layout: BERT-base MLM pretraining
    at batch 128, S 128, bf16 AMP, use_fused_attention="packed". First
    the one-step check against the plain version; then, in the order of
    LAYOUT_ROUNDS, runs of one warm and PACKED_STEPS timed steps with
    "packed" (12 + 12 + 12 launches a step on the heads' strided views:
    the TPU's resident tier), "auto" (the einsum chain below S 256,
    bench_bert's default, no launch) and True (the same kernels on
    contiguous per-head operands behind transposes), for their step
    times side by side; then BERT-tiny at the same batch and S, whose
    d 16 the TPU runs in its packed tier. A packed run's program holds
    one fused_multihead_attention_packed op a layer and no other
    attention op, so its launches are the packed layout's. Returns
    {tier: ({wrapper: launches}, {wrapper: launches in a traced replay})}
    of the last packed run and the BERT-tiny run."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    exe = fluid.Executor(dev)
    prog = packed_program(fluid, bert, bert.BertConfig.base(), "packed")
    rec = step_verdict(step_check_seeds(A, exe, fluid, bert, prog,
                                        packed_step_check), PACKED_GRAD_RTOL,
                       STEP_LOSS_MEAN["bert_packed"])
    emit(phase="bert_packed", check="step_vs_plain", seq_len=PACKED_SEQ,
         batch=PACKED_CHECK_BATCH, **rec)
    if not rec["passes"]:
        raise AssertionError("bert_packed: step kernel vs plain over data "
                             "seeds %s: past %s" % (rec["seeds"], rec["over"]))
    torch.cuda.empty_cache()

    progs = {"packed": prog}
    for label, attention in LAYOUT_ROUNDS[1:3]:
        progs[label] = packed_program(fluid, bert, bert.BertConfig.base(),
                                      attention)
    runs = [(label, "base", attention, PACKED_BATCH, PACKED_STEPS)
            for label, attention in LAYOUT_ROUNDS]
    runs.append(("tiny_packed", "tiny", "packed", PACKED_BATCH, TIER_STEPS))
    progs["tiny_packed"] = packed_program(fluid, bert,
                                          bert.BertConfig.tiny(), "packed")
    tiers, step_s_of = {}, {}
    for label, size, attention, batch, steps in runs:
        prog = progs[label]
        cfg, main = prog[0], prog[1]
        ops = main.global_block().ops
        types = {t: sum(op.type == t for op in ops) for t in (
            "fused_multihead_attention_packed", "fused_multihead_attention",
            "einsum", "cast")}
        losses, step_s, peak, got, replayed = timed_steps(
            A, exe, fluid, bert, prog, batch, steps)
        # the warm step's launches, and one replay's
        want = cfg.n_layers * (attention != "auto")
        op = {"packed": "fused_multihead_attention_packed",
              True: "fused_multihead_attention"}.get(attention)
        if [got[n] for n in FUSED_KERNELS + TENSOR_CORES] != [want] * 6 or [
                replayed[n] for n in FUSED_KERNELS + TENSOR_CORES] != [
                    want] * 6 or any(
                types[t] != (cfg.n_layers if t == op else 0) for t in (
                    "fused_multihead_attention_packed",
                    "fused_multihead_attention")):
            raise AssertionError("bert_packed (%s): launches %s over the "
                                 "warm step, %s in a traced replay (all on "
                                 "the tensor cores), ops %s"
                                 % (label, got, replayed, types))
        d = cfg.hidden // cfg.n_heads
        tier = reference_tier(PACKED_SEQ, d, (batch, cfg.n_heads, 2,
                                              (batch, 1, 1, PACKED_SEQ))) \
            if attention == "packed" else None
        if tier is not None:
            tiers[tier] = (got, replayed)
        step_s_of.setdefault(label, []).extend(step_s)
        steady = statistics.median(step_s)
        emit(phase="bert_packed",
             config="BertConfig.%s" % size, attention=label,
             amp="bf16", seq_len=PACKED_SEQ, batch=batch,
             dropout=cfg.hidden_dropout,
             masked_positions=bert.max_predictions(PACKED_SEQ),
             ops=len(ops), op_counts=types, build_s=prog[4], losses=losses,
             step_s=step_s, step_ms=steady * 1e3,
             tokens_per_s=batch * PACKED_SEQ / steady,
             max_memory_allocated_gb=peak, tier=tier,
             launches={k: v for k, v in got.items() if v},
             replay_launches={k: v for k, v in replayed.items() if v})
        del prog, main
        torch.cuda.empty_cache()
    del progs
    emit(phase="bert_packed",
         compare="BertConfig.base, batch 128, S 128, bf16 AMP: median step "
                 "ms over both runs of each layout",
         step_ms={label: statistics.median(v) * 1e3
                  for label, v in step_s_of.items() if label != "tiny_packed"},
         auto_rule="einsum below S 256, fused from S 256 (measured on a TPU)")
    return tiers


# The executor phase: config 3 (BERT-base, batch 128, S 128, bf16 AMP,
# packed) through Executor(cuda_graphs=True), the default (run 1 of a
# program and feed signature eager, run 2 captured into a CUDA graph,
# then replays), against cuda_graphs=False (every step op by op), from
# clones of one state and generator. The same kernels run in the same
# order on the same inputs (the embedding backward in a fixed order), and
# every reading on the H100 was 0.0 (PERF.md §6: losses, moments,
# iters=4, async), so graphed and eager must agree to the bit: a replay
# that dropped or repeated a small part of the step would show.
EXEC_STEPS, EXEC_TIMED = 10, 4
# graphed and eager step times in turns, each round in a fresh scope
EXEC_ROUNDS = (("graphed", True), ("eager", False), ("eager", False),
               ("graphed", True))
# the host's CUDA calls that issue work (torch.profiler's names)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")
EXEC_KERNELS = ("attn_fwd_mma", "attn_bwd_dq_mma", "attn_bwd_dkdv_mma")


# Idle seconds a trace keeps on each side of what it traces: the
# profiler drops device events that fall outside its window on the
# host's clock, and the device's clock, converted to it, can run off by
# enough to lose the first kernels of a replay launched right after the
# window opens.
TRACE_PAD_S = 0.1
# Even so a trace can lose the first device events of its window: the
# whole smoke's VGG16-BN replays were traced with 1413 and 1417 of the
# 1452 kernels a complete trace holds, the first convolutions' missing,
# in every one of TRACE_TRIES traces (PERF.md §6). So each trace first runs sentinel
# kernels of its own (``torch.cuda._sleep``: one of about 20 ms, then
# TRACE_SENTINELS short ones), waits for them, and only then calls
# ``fn``; a loss falls on the sentinels, which are taken out of the
# result. How many of them each trace lost is kept in TRACE_LOSSES.
TRACE_SENTINELS = 256
SENTINEL_CYCLES = (40_000_000, 4000)        # ~20 ms, ~2 us at 1.98 GHz
SENTINEL_KERNEL = "spin_kernel"
TRACE_LOSSES = []


def host_launches(fn):
    """The host's launch calls (``LAUNCH_APIS``, by name) and the
    device's kernels ({name: (us, calls)}) of one call of ``fn``, from a
    torch.profiler trace with TRACE_PAD_S of idle time on each side and
    the sentinel kernels ahead of ``fn`` (taken out of both)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        torch.cuda._sleep(SENTINEL_CYCLES[0])
        for _ in range(TRACE_SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES[1])
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    api = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key in LAUNCH_APIS}
    kern = kernel_times(prof)
    sentinels = 1 + TRACE_SENTINELS
    seen = sum(kern.pop(k)[1] for k in list(kern) if SENTINEL_KERNEL in k)
    TRACE_LOSSES.append(sentinels - seen)
    launched = api.pop("cudaLaunchKernel", 0) - sentinels
    if launched > 0:
        api["cudaLaunchKernel"] = launched
    return api, kern


# A torch.profiler trace can miss the first events of what it traces:
# one trace at S 8192 held 10 of a replay's 12 attn_fwd_mma kernels,
# though the graph holds 12 and the traces before it held 12; another
# lost a config-3 replay's first 50 events (TRACE_PAD_S). A trace never
# adds a kernel, so of TRACE_TRIES traces, one ``fn()`` each, the one
# with the most device events stands for the replay: a kernel missing
# from all of them is missing from the graph.
TRACE_TRIES = 3


def complete_trace(fn, tries=TRACE_TRIES):
    """(launch calls, {kernel: (us, calls)}, device kernels of each
    trace, each trace's {kernel: calls} where it differs from the
    chosen one) of the most complete of ``tries`` traces
    (``host_launches``) of one ``fn()`` each."""
    traces = [host_launches(fn) for _ in range(tries)]
    totals = [sum(n for _, n in kern.values()) for _, kern in traces]
    api, kern = traces[totals.index(max(totals))]
    diffs = [{k[:80]: other.get(k, (0, 0))[1] - kern.get(k, (0, 0))[1]
              for k in set(other) | set(kern)
              if other.get(k, (0, 0))[1] != kern.get(k, (0, 0))[1]}
             for _, other in traces]
    return api, kern, totals, diffs


def rel_diff(a, b):
    """max |a - b| over max |b| (tensors or sequences of floats)."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).abs().max() / b.abs().max()).item()


def executor_path(A, monitor, dev):
    """Config 3 graphed against eager (see EXEC_STEPS): 10 steps at p 0
    (losses and the watched first moments, equal to the bit); at the program's p 0.1 the
    first 5 steps beside eager's (whether replays reproduce the eager
    draws: a finding) and, from one state, a replay with the generator
    rewound (its loss must repeat) against one without (it must differ:
    the masks change between replays); the three *_mma kernels by name
    in a profiler trace of one replay, 12 launches each, and the host's
    launch calls of a graphed and an eager step; iters=4 against four
    single graphed runs; two async replays read after both against two
    sync ones; then EXEC_ROUNDS of step times. Returns the replay's
    kernel calls."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    replays = monitor.counter("executor_graph_replay_total")
    cfg0 = bert.BertConfig.base()
    cfg0.hidden_dropout = cfg0.attn_dropout = 0.0
    cfg, main, startup, loss, _ = packed_program(fluid, bert, cfg0, "packed")
    feed = bert.synthetic_batch(cfg, PACKED_BATCH, PACKED_SEQ, seed=0)
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)

    def steps(exe, sc, n, **kw):
        return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=sc, **kw)[0]).reshape(-1)[0])
                for _ in range(n)]

    runs = {}
    for label, graphs in (("graphed", True), ("eager", False)):
        sc = clone_scope(fluid, scope)
        exe = fluid.Executor(dev, cuda_graphs=graphs)
        reset_launches(A)
        r0 = replays.value
        runs[label] = (steps(exe, sc, EXEC_STEPS), {
            n: sc.find_var(n + "_moment1_0") for n in BERT_WATCH},
            replays.value - r0, launches(A, FUSED_KERNELS))
        exe.close()
        del sc
    (g_loss, g_m1, g_replays, g_launched) = runs["graphed"]
    (e_loss, e_m1, e_replays, e_launched) = runs["eager"]
    grad_rel = {n: rel_diff(g_m1[n], e_m1[n]) for n in BERT_WATCH}
    rec = dict(phase="executor", config="BertConfig.base, packed",
               amp="bf16", seq_len=PACKED_SEQ, batch=PACKED_BATCH,
               check="graphed_vs_eager", dropout=0.0, steps=EXEC_STEPS,
               losses_graphed=g_loss, losses_eager=e_loss,
               loss_rel=rel_diff(g_loss, e_loss), grad_rel=grad_rel,
               moments_equal=all(torch.equal(g_m1[n], e_m1[n])
                                 for n in BERT_WATCH),
               replays=g_replays, eager_replays=e_replays,
               launches=g_launched, eager_launches=e_launched)
    emit(**rec)
    # the wrappers launch in the graphed run's first (eager) step only
    if not (g_loss == e_loss and rec["moments_equal"] and
            g_replays == EXEC_STEPS - 1 and e_replays == 0 and
            all(v == cfg.n_layers for v in g_launched.values()) and
            all(v == cfg.n_layers * EXEC_STEPS
                for v in e_launched.values())):
        raise AssertionError("executor: graphed vs eager past its limits: "
                             "%s" % rec)
    del runs, g_m1, e_m1

    # iters=4 against four single graphed runs; then two sync replays
    # against two async ones, read after both
    a, b, c = (clone_scope(fluid, scope) for _ in range(3))
    stacked = {k: np.stack([v] * 4) for k, v in feed.items()}
    exe = fluid.Executor(dev)
    window = np.asarray(exe.run(main, feed=stacked, fetch_list=[loss],
                                scope=a, iters=4)[0]).reshape(4, -1)[:, 0]
    single = steps(exe, b, 4)
    sync = steps(exe, b, 2)
    steps(exe, c, 4)
    handles = [exe.run(main, feed=feed, fetch_list=[loss], scope=c,
                       fetch_mode="async")[0] for _ in range(2)]
    async_ = [float(h.numpy().reshape(-1)[0]) for h in handles]
    rec = dict(phase="executor", check="iters_and_async",
               iters_window=window.tolist(), single_runs=single,
               iters_rel=rel_diff(window, single), async_losses=async_,
               sync_losses=sync, async_rel=rel_diff(async_, sync))
    emit(**rec)
    if not (window.tolist() == single and async_ == sync and
            async_[0] != async_[1]):
        raise AssertionError("executor: iters=4 or async past the limit: "
                             "%s" % rec)
    exe.close()
    del a, b, c, scope

    # the program's own dropout, p 0.1
    cfg, main, startup, loss, _ = packed_program(
        fluid, bert, bert.BertConfig.base(), "packed")
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    sc = clone_scope(fluid, scope)
    eager = steps(fluid.Executor(dev, cuda_graphs=False), sc, 5)
    exe = fluid.Executor(dev)
    graphed = steps(exe, scope, 5)
    del sc
    state = {n: scope.find_var(n).clone() for n in scope.local_var_names()}
    rng = scope.generator.get_state()

    def replay(rewind):
        for n, t in state.items():
            scope.find_var(n).copy_(t)
        if rewind:
            scope.generator.set_state(rng)
        return steps(exe, scope, 1)[0]

    first = replay(True)
    rec = dict(phase="executor", check="dropout_masks", dropout=0.1,
               losses_graphed=graphed, losses_eager=eager,
               replays_equal_eager=graphed == eager,
               replays_rel_to_eager=rel_diff(graphed, eager),
               replay_loss=first, rewound_replay_loss=replay(True),
               next_replay_loss=replay(False))
    rec["same_seed_repeats"] = rec["rewound_replay_loss"] == first
    rec["masks_change"] = rec["next_replay_loss"] != first
    del state

    # the kernels of one replay by name; the host's launch calls a step
    api, kern, traced, diffs = complete_trace(lambda: steps(exe, scope,
                                                            1))
    calls = traced_launches(kern)
    named = {name: sum(n for k, (_, n) in kern.items() if name + "<" in k)
             for name in EXEC_KERNELS}
    e_exe = fluid.Executor(dev, cuda_graphs=False)
    e_sc = clone_scope(fluid, scope)
    steps(e_exe, e_sc, 1)
    e_api, e_kern = host_launches(lambda: steps(e_exe, e_sc, 1))
    rec.update(replay_kernels=named, replay_launches=calls,
               replay_host_launches=api,
               replay_device_kernels=sum(n for _, n in kern.values()),
               kernels_per_trace=traced, trace_diffs=diffs,
               eager_host_launches=e_api,
               eager_device_kernels=sum(n for _, n in e_kern.values()))
    emit(**rec)
    if not (rec["same_seed_repeats"] and rec["masks_change"] and
            all(math.isfinite(x) for x in graphed) and
            all(n == cfg.n_layers for n in list(calls.values()) +
                list(named.values()))):
        raise AssertionError("executor: p 0.1 replays or the replay's "
                             "kernels: %s" % rec)
    exe.close()
    del scope, e_sc
    torch.cuda.empty_cache()

    # step times, graphed and eager in turns (timed_steps, fresh scopes)
    prog = (cfg, main, startup, loss, 0.0)
    times = {}
    for label, graphs in EXEC_ROUNDS:
        exe = fluid.Executor(dev, cuda_graphs=graphs)
        r0 = replays.value
        losses, step_s, peak, got, replayed = timed_steps(
            A, exe, fluid, bert, prog, PACKED_BATCH, EXEC_TIMED)
        steady = statistics.median(step_s)
        times.setdefault(label, []).extend(step_s)
        emit(phase="executor", check="step_times", mode=label,
             step_s=step_s, step_ms=steady * 1e3,
             tokens_per_s=PACKED_BATCH * PACKED_SEQ / steady,
             max_memory_allocated_gb=peak, losses=losses,
             replays=replays.value - r0, launches=got,
             replay_launches=replayed)
        # graphed: the capture's replay, the timed ones, the traced ones
        if graphs and replays.value - r0 != EXEC_TIMED + 1 + TRACE_TRIES:
            raise AssertionError("executor: %d replays over %d timed steps"
                                 % (replays.value - r0, EXEC_TIMED))
    emit(phase="executor", check="step_times_compare",
         step_ms={k: statistics.median(v) * 1e3 for k, v in times.items()},
         host_launches_per_step={"graphed": api, "eager": e_api})
    return calls


SERVE_SEQ, SERVE_REQUESTS, SERVE_CLIENTS = 128, 64, 8
# Each served request's encoder output against a direct Predictor.run of
# the same rows (fp32): the attention kernels treat every (row, head)
# alone, so only the cuBLAS products, whose algorithm may change with
# the batch's row count, sum in another order.
SERVE_ATOL = 1e-4


def encoder_serving_path(A, inference, monitor, dev):
    """The non-generative serving tier: a BERT-base encoder (S 128,
    use_fused_attention="packed", fp32) built, started on the card,
    saved with save_inference_model and loaded back as a Predictor,
    behind a Server (batches up to 32, 2 ms queue delay, ladder warmed
    up: each bucket run twice, the second capturing its CUDA graph);
    SERVE_REQUESTS requests of 1-4 padded rows from SERVE_CLIENTS
    threads, served from the graphs and then, in the same call, by a
    predictor with capture off (every batch op by op). Every future is
    held to a direct Predictor.run of its rows through an eager clone
    (capture off in both modes, so a graphed batch is held to the op by
    op path). The wrappers' launches are counted from the warm-up on:
    graphed, only each bucket's first (eager) run launches through them,
    and one more replay of the one-row bucket, traced, names the forward
    kernel. Returns the wrappers' launches of the graphed run and that
    replay's kernels."""
    import tempfile

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.use_fused_attention = "packed"
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg,
                                                        seq_len=SERVE_SEQ)
    exe, scope = fluid.Executor(dev), fluid.Scope()
    rng = np.random.RandomState(5)
    rows = bert.synthetic_batch(cfg, 4 * SERVE_REQUESTS, SERVE_SEQ, seed=5)
    lens = rng.randint(SERVE_SEQ // 2, SERVE_SEQ + 1, 4 * SERVE_REQUESTS)
    rows["input_mask"][np.arange(SERVE_SEQ)[None, :] >= lens[:, None]] = 0.0
    sizes = rng.randint(1, 5, SERVE_REQUESTS)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    reqs = [{n: rows[n][s:s + k] for n in feeds}
            for s, k in zip(starts, sizes)]
    lbl = {"model": "bert_encoder"}
    occ = monitor.histogram("serving_batch_occupancy", labels=lbl)
    batches = monitor.counter("serving_batches_total", labels=lbl)
    replays = monitor.counter("executor_graph_replay_total")
    served_launches = None
    with tempfile.TemporaryDirectory() as model_dir:
        with fluid.scope_guard(scope):
            exe.run(startup, scope=scope)
            fluid.io.save_inference_model(model_dir, feeds, [enc], exe,
                                          main_program=main)
        del exe, scope
        for mode in ("graphed", "eager"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pred = inference.create_predictor(inference.Config(model_dir))
            load_s = time.perf_counter() - t0
            pred._exe.cuda_graphs = mode == "graphed"
            direct = pred.clone()
            direct._exe.cuda_graphs = False
            results, latency = [None] * len(reqs), [None] * len(reqs)
            exemplar = {n: reqs[0][n][:1] for n in feeds}
            with inference.Server() as srv:
                reset_launches(A)
                t0 = time.perf_counter()
                r0 = replays.value
                ladder = srv.register(
                    "bert_encoder", pred,
                    config=inference.ServeConfig(max_batch_size=32,
                                                 max_queue_delay_ms=2.0),
                    warmup_feed=exemplar)
                torch.cuda.synchronize()
                warmup_s = time.perf_counter() - t0
                warm_replays = replays.value - r0
                peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
                reserved_gb = torch.cuda.memory_reserved() / 2 ** 30
                occ0, batches0, r0 = (occ.sum, occ.count), batches.value, \
                    replays.value
                t0 = time.perf_counter()

                def client(c):
                    for i in range(c, len(reqs), SERVE_CLIENTS):
                        ts = time.perf_counter()
                        results[i] = srv.submit("bert_encoder",
                                                reqs[i]).result(timeout=600)
                        latency[i] = time.perf_counter() - ts

                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(SERVE_CLIENTS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                    if t.is_alive():
                        raise AssertionError("encoder_serving client "
                                             "thread hung")
                wall = time.perf_counter() - t0
            n_batches = batches.value - batches0
            served_replays = replays.value - r0
            replayed = traced_replay(pred._exe, lambda: pred.run(exemplar),
                                     "encoder_serving", mode=mode)
            served = launches(A, FUSED_KERNELS)
            if any(r is None for r in results):
                raise AssertionError("encoder_serving: unresolved futures")
            # graphed: each bucket's warm run; eager: both warm-up runs
            # of every bucket and every served batch
            want = cfg.n_layers * (len(ladder) if mode == "graphed" else
                                   2 * len(ladder) + n_batches)
            if not (served["fused_attention_fwd_kernel"] == served[FWD_TC]
                    == want > 0 and
                    sum(served[n] for n in FUSED_KERNELS) ==
                    served["fused_attention_fwd_kernel"] and
                    (replayed is None or
                     (replayed["fused_attention_fwd_kernel"] ==
                      replayed[FWD_TC] == cfg.n_layers and
                      sum(replayed[n] for n in FUSED_KERNELS) ==
                      cfg.n_layers))):
                raise AssertionError("encoder_serving (%s): launches %s "
                                     "from the warm-up on (want %d), %s in "
                                     "a traced replay"
                                     % (mode, served, want, replayed))
            # graphed: the ladder captured at warm-up (one replay a
            # bucket), then every served batch a replay
            want = (len(ladder), n_batches) if mode == "graphed" else (0, 0)
            if (warm_replays, served_replays) != want:
                raise AssertionError(
                    "encoder_serving (%s): %d warm-up and %d served "
                    "replays, want %s" % (mode, warm_replays,
                                          served_replays, want))
            err = ref = 0.0
            for req, got in zip(reqs, results):
                expect = direct.run(req)[0]
                if got[0].shape != expect.shape or \
                        not np.isfinite(got[0]).all():
                    raise AssertionError("encoder_serving: output %s, want "
                                         "%s" % (got[0].shape, expect.shape))
                err = max(err, float(np.abs(got[0] - expect).max()))
                ref = max(ref, float(np.abs(expect).max()))
            if not err <= SERVE_ATOL:
                raise AssertionError("encoder_serving: served vs direct max "
                                     "|err| %g > %g" % (err, SERVE_ATOL))
            lat = np.array(latency)
            emit(phase="encoder_serving",
                 config="BertConfig.base encoder, packed", mode=mode,
                 seq_len=SERVE_SEQ, dtype="float32", requests=len(reqs),
                 rows=int(sizes.sum()), clients=SERVE_CLIENTS,
                 max_batch_size=32, max_queue_delay_ms=2.0, ladder=ladder,
                 load_s=load_s, warmup_s=warmup_s, wall_s=wall,
                 batches=n_batches, warmup_replays=warm_replays,
                 served_replays=served_replays,
                 max_memory_allocated_gb=peak_gb,
                 memory_reserved_gb=reserved_gb,
                 occupancy_mean=(occ.sum - occ0[0]) / (occ.count - occ0[1]),
                 request_p50_s=float(np.percentile(lat, 50)),
                 request_p99_s=float(np.percentile(lat, 99)),
                 rows_per_s=float(sizes.sum()) / wall,
                 packed_fwd_launches=served["fused_attention_fwd_kernel"],
                 replay_launches=replayed,
                 vs_direct_max_abs_err=err, vs_direct_atol=SERVE_ATOL,
                 output_max_abs=ref)
            if served_launches is None:
                served_launches = (served, replayed)
            del pred, direct
    return served_launches


# -- the cold start and the serving fleet ------------------------------------------
# the encoder_serving phase's ladder and requests, served by processes that
# start from save_inference_model(prelower=True)'s __prelowered__/
COLD_CHILD_TIMEOUT_S = 300
FLEET_REPLICAS, FLEET_TERM_AFTER = 2, 16
FLEET_REGISTER_TIMEOUT_S = 240


def encoder_requests(bert, cfg):
    """The encoder_serving phase's SERVE_REQUESTS requests (1-4 rows of
    S SERVE_SEQ with ragged masks), from its seeds."""
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    rng = np.random.RandomState(5)
    rows = bert.synthetic_batch(cfg, 4 * SERVE_REQUESTS, SERVE_SEQ, seed=5)
    lens = rng.randint(SERVE_SEQ // 2, SERVE_SEQ + 1, 4 * SERVE_REQUESTS)
    rows["input_mask"][np.arange(SERVE_SEQ)[None, :] >= lens[:, None]] = 0.0
    sizes = rng.randint(1, 5, SERVE_REQUESTS)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return feeds, [{n: rows[n][s:s + k] for n in feeds}
                   for s, k in zip(starts, sizes)]


def cold_start_child(model_dir, req_path, out_path, spawned, place="cuda"):
    """One cold process of the cold_start phase (``python3 chip_smoke.py
    --cold-start-child MODEL_DIR REQ OUT SPAWNED [PLACE]``): a Predictor
    over MODEL_DIR and a Server with the ladder's warm-up, one request
    (REQ, an .npz of feeds) answered into OUT; prints one JSON line with
    the seconds from SPAWNED (the parent's clock at spawn) by part, the
    nvcc runs, the warm-up's disk hits, the live compiles, the
    quarantines and where the attention library came from. PLACE "cpu"
    rehearses it on the CPU."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.fluid import monitor
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import replica

    import_s = time.time() - float(spawned)
    req = dict(np.load(req_path))
    exemplar = {n: v[:1] for n, v in req.items()}
    dev = torch.device(place)
    compiles0 = replica._live_compile_count()
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(model_dir,
                                                       place=place))
    sync(dev)
    load_s = time.perf_counter() - t0
    srv = inference.Server()
    t0 = time.perf_counter()
    ladder = srv.register("bert_encoder", pred, config=inference.ServeConfig(
        max_batch_size=32, max_queue_delay_ms=2.0), warmup_feed=exemplar)
    sync(dev)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = srv.submit("bert_encoder", req).result(timeout=600)[0]
    answer_s = time.perf_counter() - t0
    srv.close()
    np.save(out_path, out)
    print(json.dumps(dict(
        import_s=import_s, load_s=load_s, warmup_s=warmup_s,
        answer_s=answer_s, first_answer_s=time.time() - float(spawned),
        ladder=ladder, nvcc_runs=_build.nvcc_runs,
        nvcc_s=_build.nvcc_seconds,
        live_compiles=replica._live_compile_count() - compiles0,
        warmup_disk_hits=monitor.counter(
            "serving_warmup_disk_hits_total",
            labels={"model": "bert_encoder"}).value,
        disk_misses=monitor.counter(
            "executor_compile_cache_disk_miss_total").value,
        quarantined=monitor.counter(
            "compile_cache_quarantined_total").value,
        library=_build.loaded_from("fused_attention"))), flush=True)
    return 0


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def cold_start_path(inference, dev, tmp, model_dir, reqs, direct, ladder):
    """The cold_start phase's three children (module docstring); returns
    their records."""
    from paddle_tpu_torch.fluid import compile_cache
    from paddle_tpu_torch.kernels import _build

    here = os.path.dirname(os.path.abspath(__file__))
    np.savez(os.path.join(tmp, "req.npz"), **reqs[0])
    pre = os.path.join(model_dir, compile_cache.PRELOWERED_DIRNAME)
    lib = os.path.join(pre, compile_cache.KERNELS_DIRNAME,
                       _build.lib_name("fused_attention"))
    cache1 = os.path.join(tmp, "cache1")
    records = {}
    # the CPU (a rehearsal) launches no library to truncate
    cases = ("prelowered", "cache_dir") + (
        ("truncated_library",) if dev.type == "cuda" else ())
    for case in cases:
        cache = cache1 if case != "truncated_library" else \
            os.path.join(tmp, "cache3")
        os.makedirs(cache, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=here,
                   **{compile_cache.ENV_DIR: cache})
        if case != "truncated_library":
            # no _build/ in reach: a library comes from a tier or nvcc
            empty = os.path.join(tmp, "no_build_" + case)
            os.makedirs(empty)
            env[_build.ENV_BUILD_DIR] = empty
        if case == "cache_dir":
            os.rename(pre, pre + ".aside")
        if case == "truncated_library":
            shutil.copyfile(lib, lib + ".intact")
            with open(lib, "r+b") as f:
                f.truncate(os.path.getsize(lib) // 3)
        out = os.path.join(tmp, "out_%s.npy" % case)
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--cold-start-child", model_dir,
                 os.path.join(tmp, "req.npz"), out, repr(time.time()),
                 dev.type],
                env=env, cwd=here, capture_output=True, text=True,
                timeout=COLD_CHILD_TIMEOUT_S)
        finally:
            if case == "cache_dir":
                os.rename(pre + ".aside", pre)
        quarantined = os.path.exists(lib + compile_cache.QUARANTINE_SUFFIX)
        if case == "truncated_library":
            # the fleet phase serves this export next: its library whole
            os.replace(lib + ".intact", lib)
            if quarantined:
                os.remove(lib + compile_cache.QUARANTINE_SUFFIX)
        got = [json.loads(line) for line in r.stdout.splitlines()
               if line.startswith("{")]
        if r.returncode != 0 or not got:
            raise AssertionError("cold_start (%s): child exit %d\n%s"
                                 % (case, r.returncode, r.stderr[-3000:]))
        rec = got[-1]
        err = float(np.abs(np.load(out) - direct[0]).max())
        loaded = rec["library"] or ""
        rec.update(case=case, vs_direct_max_abs_err=err, library=(
            "__prelowered__/kernels/" if loaded.startswith(pre) else
            "$PADDLE_COMPILE_CACHE_DIR/kernels/" if loaded.startswith(cache)
            else "_build/") + os.path.basename(loaded))
        emit(phase="cold_start", **rec)
        if not err <= SERVE_ATOL:
            raise AssertionError("cold_start (%s): answer vs the parent's "
                                 "Predictor max |err| %g > %g"
                                 % (case, err, SERVE_ATOL))
        if case == "truncated_library":
            if not (rec["quarantined"] >= 1 and quarantined):
                raise AssertionError("cold_start: the truncated library "
                                     "was not quarantined: %s" % rec)
        elif (rec["nvcc_runs"], rec["live_compiles"],
              rec["warmup_disk_hits"]) != (0, 0, len(ladder)) or (
                dev.type == "cuda" and not rec["library"].startswith(
                    "__prelowered__" if case == "prelowered" else "$")):
            raise AssertionError("cold_start (%s): want 0 nvcc runs, 0 "
                                 "live compiles, %d disk hits and the "
                                 "library from the tier, got %s"
                                 % (case, len(ladder), rec))
        records[case] = rec
    return records


def wait_for(cond, timeout, what):
    deadline = time.time() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.time() > deadline:
            raise AssertionError("fleet: timed out waiting for " + what)
        time.sleep(0.1)


def fleet_traffic(submit, reqs, on_done=None):
    """``reqs`` from SERVE_CLIENTS threads, each with its own
    ``submit = make()``: (results, latencies); ``on_done(n)`` after the
    n-th answer."""
    results, latency = [None] * len(reqs), [None] * len(reqs)
    done, mu, errs = [0], threading.Lock(), []

    def client(c):
        call = submit()
        try:
            for i in range(c, len(reqs), SERVE_CLIENTS):
                ts = time.perf_counter()
                results[i] = call(reqs[i])
                latency[i] = time.perf_counter() - ts
                with mu:
                    done[0] += 1
                    n = done[0]
                if on_done is not None:
                    on_done(n)
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append(e)
        finally:
            closer = getattr(call, "close", None)
            if closer is not None:
                closer()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("fleet: a client thread hung")
    if errs:
        raise AssertionError("fleet: a client failed: %r" % errs[0])
    if any(r is None for r in results):
        raise AssertionError("fleet: unanswered requests")
    return results, latency


def fleet_path(A, inference, monitor, dev, tmp, model_dir, feeds, reqs,
               direct, ladder, n_layers):
    """The fleet phase (module docstring)."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed.coordination import (CoordClient,
                                                           CoordServer)
    from paddle_tpu_torch.fluid import compile_cache
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import (FleetClient, FleetSupervisor,
                                          Replica, Router)
    from paddle_tpu_torch.telemetry import pusher

    here = os.path.dirname(os.path.abspath(__file__))
    warm = {n: {"shape": [1] + list(reqs[0][n].shape[1:]),
                "dtype": str(reqs[0][n].dtype)} for n in feeds}
    spec = {"prefix": "fleet/", "models": [{
        "name": "bert_encoder", "model_dir": model_dir, "warmup": warm,
        "place": dev.type,
        "config": {"max_batch_size": 32, "max_queue_delay_ms": 2.0}}]}
    hb = os.path.join(tmp, "hb")
    for d in (hb, os.path.join(tmp, "fleet_cache"),
              os.path.join(tmp, "fleet_no_build")):
        os.makedirs(d)
    env = {"PYTHONPATH": here, "PADDLE_HEARTBEAT_DIR": hb,
           compile_cache.ENV_DIR: os.path.join(tmp, "fleet_cache"),
           _build.ENV_BUILD_DIR: os.path.join(tmp, "fleet_no_build"),
           "PADDLE_FLEET_LEASE_TTL": "3.0", "PADDLE_TELEMETRY": "1",
           "PADDLE_TELEMETRY_PUSH_MS": "200"}
    coord = CoordServer().start()
    addr = coord.endpoint
    dbg = CoordClient(addr)
    sup = FleetSupervisor(spec, FLEET_REPLICAS, addr, env=env,
                          log_dir=os.path.join(tmp, "fleet_logs"))
    router = rep = None
    requeued = monitor.counter("fleet_requeued_total")

    def blobs():
        out = {}
        for key in dbg.live_members("fleet/replicas/"):
            raw = dbg.get(key)
            if raw is not None:
                info = json.loads(raw.decode())
                out[info["replica"]] = info
        return out

    def check_blob(info, what):
        if (info["live_compiles"], info["nvcc_runs"],
                info["warmup_disk_hits"]) != (0, 0, len(ladder)):
            raise AssertionError("fleet: %s registered with %s (want 0 "
                                 "live compiles, 0 nvcc runs, %d disk "
                                 "hits)" % (what, info, len(ladder)))

    try:
        t0 = time.perf_counter()
        sup.start()
        try:
            first = wait_for(lambda: (lambda b: b if len(b) == FLEET_REPLICAS
                                      else None)(blobs()),
                             FLEET_REGISTER_TIMEOUT_S, "the replicas")
        except AssertionError:
            raise AssertionError("fleet: replicas never registered:\n" +
                                 "\n".join(open(sup.log_path(r)).read()[-2000:]
                                           for r in sup.replica_ids()))
        start_s = time.perf_counter() - t0
        for rid, info in first.items():
            check_blob(info, rid)
        router = Router(coord_addr=addr, refresh_interval=0.05).start()
        endpoint = "%s:%d" % (router.host, router.port)
        wait_for(lambda: len(router.members()) == FLEET_REPLICAS, 30,
                 "the router's table")
        victim = sorted(first)[0]
        term = {}

        def sigterm(n):
            if n == FLEET_TERM_AFTER and not term:
                term["t"] = time.time()
                term["thread"] = threading.Thread(
                    target=lambda: term.__setitem__(
                        "rc", sup.drain(victim, respawn=True, timeout=120)))
                term["thread"].start()

        def fleet_client():
            cli = FleetClient(endpoint)
            call = lambda feed: cli.submit("bert_encoder", feed,
                                           deadline_ms=600000)[0]
            call.close = cli.close
            return call

        rq0 = requeued.value
        results, lat = fleet_traffic(fleet_client, reqs, on_done=sigterm)
        term["thread"].join(timeout=150)
        marker = os.path.join(hb, "hb.0.preempted")
        if term.get("rc") != 0 or not os.path.exists(marker):
            raise AssertionError("fleet: the SIGTERM'd replica exited %s, "
                                 "marker %s" % (term.get("rc"),
                                                os.path.exists(marker)))
        old_pid = first[victim]["pid"]
        reborn = wait_for(lambda: (lambda b: b.get(victim) if b.get(
            victim, {}).get("pid", old_pid) != old_pid else None)(blobs()),
            FLEET_REGISTER_TIMEOUT_S, "the respawned replica")
        respawn_s = time.time() - term["t"]
        check_blob(reborn, "the respawned " + victim)
        err = max(float(np.abs(got - want).max())
                  for got, want in zip(results, direct))
        if not err <= SERVE_ATOL:
            raise AssertionError("fleet: answers vs direct max |err| %g > "
                                 "%g" % (err, SERVE_ATOL))
        # one traced request: client -> router -> replica -> executor.run
        telemetry.enable()
        try:
            with FleetClient(endpoint) as cli:
                cli.submit("bert_encoder", reqs[0], deadline_ms=600000)
            mine = [r for r in telemetry.snapshot()
                    if r["name"] == "client.submit"]
            tid = mine[-1]["trace_id"]

            def remote():
                got = [r for spans in pusher.collect_spans(addr)
                       for r in spans if r.get("trace_id") == tid]
                return got if "executor.run" in {r["name"] for r in got} \
                    else None
            trace = telemetry.trace_spans(tid) + wait_for(
                remote, 30, "the replica's spans of the traced request")
        finally:
            telemetry.disable()
        names = sorted({r["name"] for r in trace})
        want_names = {"client.submit", "router.route", "router.dispatch",
                      "replica.infer", "serving.batch", "executor.run"}
        if not want_names <= set(names) or \
                len({r["trace_id"] for r in trace}) != 1:
            raise AssertionError("fleet: the traced request's spans %s "
                                 "(want %s in one trace)"
                                 % (names, sorted(want_names)))
        # the in-process Server beside it, in a Replica of this process
        rep = Replica(spec, replica_id="inproc").start()
        if (rep.live_compiles, rep.nvcc_runs) != (0, 0):
            raise AssertionError("fleet: the in-process replica built %d "
                                 "steps and ran nvcc %d times"
                                 % (rep.live_compiles, rep.nvcc_runs))

        def local():
            return lambda feed: rep._server.submit(
                "bert_encoder", feed).result(timeout=600)[0]
        local_results, local_lat = fleet_traffic(local, reqs)
        local_err = max(float(np.abs(got - want).max())
                        for got, want in zip(local_results, direct))
        pred = rep._server._models["bert_encoder"].predictor
        exemplar = {n: reqs[0][n][:1] for n in feeds}
        replayed = traced_replay(pred._exe, lambda: pred.run(exemplar),
                                 "fleet")
        if not (local_err <= SERVE_ATOL and (dev.type != "cuda" or (
                replayed is not None and
                replayed["fused_attention_fwd_kernel"] == replayed[FWD_TC]
                == n_layers and sum(replayed[n] for n in FUSED_KERNELS) ==
                n_layers))):
            raise AssertionError("fleet: in-process replica err %g, traced "
                                 "replay %s (want the forward %d times)"
                                 % (local_err, replayed, n_layers))
        lat, local_lat = np.array(lat), np.array(local_lat)
        rec = dict(
            phase="fleet", replicas=FLEET_REPLICAS, requests=len(reqs),
            clients=SERVE_CLIENTS, start_s=start_s,
            registered={rid: {k: info[k] for k in (
                "live_compiles", "nvcc_runs", "warmup_disk_hits")}
                for rid, info in first.items()},
            sigterm_after=FLEET_TERM_AFTER, drained=victim,
            drain_rc=term["rc"], marker=True, respawn_s=respawn_s,
            respawned={k: reborn[k] for k in (
                "pid", "live_compiles", "nvcc_runs", "warmup_disk_hits")},
            respawns=sup.respawns, requeued=requeued.value - rq0,
            vs_direct_max_abs_err=err, vs_direct_atol=SERVE_ATOL,
            fleet_p50_s=float(np.percentile(lat, 50)),
            fleet_p99_s=float(np.percentile(lat, 99)),
            in_process_p50_s=float(np.percentile(local_lat, 50)),
            in_process_p99_s=float(np.percentile(local_lat, 99)),
            in_process_max_abs_err=local_err, trace_spans=names,
            replay_launches=replayed)
        emit(**rec)
        return rec
    finally:
        if rep is not None:
            rep.drain(timeout=30)
        if router is not None:
            router.close()
        dbg.close()
        sup.stop(timeout=60)
        coord.stop()


def served_fleet(A, inference, monitor, dev, cfg=None):
    """Phases cold_start and fleet over one export of the encoder_serving
    phase's model (module docstring; ``cfg`` another BertConfig, such as
    a CPU rehearsal's tiny one). Returns where the served replicas'
    attention library came from, for the kernels line."""
    import tempfile

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import compile_cache
    from paddle_tpu_torch.models import bert

    cfg = cfg or bert.BertConfig.base()
    cfg.use_fused_attention = "packed"
    feeds, reqs = encoder_requests(bert, cfg)
    ladder = inference.ServeConfig(max_batch_size=32).ladder()
    with fluid.unique_name.guard():
        main, startup, enc = bert.build_encoder_program(cfg,
                                                        seq_len=SERVE_SEQ)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "model")
        exe, scope = fluid.Executor(dev), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup, scope=scope)
            t0 = time.perf_counter()
            fluid.io.save_inference_model(
                model_dir, feeds, [enc], exe, main_program=main,
                prelower=True, prelower_batch_sizes=ladder)
            export_s = time.perf_counter() - t0
        del exe, scope
        pre = os.path.join(model_dir, compile_cache.PRELOWERED_DIRNAME)
        kdir = os.path.join(pre, compile_cache.KERNELS_DIRNAME)
        emit(phase="cold_start", check="export", ladder=ladder,
             export_s=export_s, prelowered_bytes=dir_bytes(pre),
             entries=len([f for f in os.listdir(pre)
                          if f.endswith(compile_cache.ENTRY_SUFFIX)]),
             libraries=sorted(f for f in (os.listdir(kdir) if
                                          os.path.isdir(kdir) else ())
                              if f.endswith(".so")),
             model_bytes=dir_bytes(model_dir) - dir_bytes(pre))
        direct = inference.create_predictor(inference.Config(
            model_dir, place=dev.type))
        direct._exe.cuda_graphs = False
        want = [direct.run(r)[0] for r in reqs]
        del direct
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cold = cold_start_path(inference, dev, tmp, model_dir, reqs, want,
                               ladder)
        fleet = fleet_path(A, inference, monitor, dev, tmp, model_dir,
                           feeds, reqs, want, ladder, cfg.n_layers)
        emit(phase="fleet", check="phase_seconds",
             cold_start_and_fleet_s=time.perf_counter() - t0 + export_s)
    return {case: {"library": rec["library"], "nvcc_runs": rec["nvcc_runs"]}
            for case, rec in cold.items()} | {
        "fleet_replicas_nvcc_runs": [
            v["nvcc_runs"] for v in fleet["registered"].values()] +
        [fleet["respawned"]["nvcc_runs"]]}


# -- BASELINE configs 1 and 2: LeNet and ResNet-50 through the IR ----------------
LENET_BATCH, LENET_WARM, LENET_ITERS, LENET_WINDOWS = 1024, 10, 100, 3
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
RESNET_ROUNDS = ("NCHW", "NHWC", "NHWC", "NCHW")     # interleaved
RESNET_WARM, RESNET_TIMED = 2, 6
CHECK_STEPS = 3
# the card against the port's own CPU path: ResNet-18, fp32 (TF32 off),
# a fresh batch each step. At 32x32 a deep batch-norm network on a few
# images is chaotic in fp32 (the port's fp32 losses leave its own
# float64 run by 1e-2 within 3 steps at batch 8); at 64x64 by 1.3e-4.
CARD_CPU_SIZE, CARD_CPU_BATCH, CARD_CPU_RTOL = 64, 8, 1e-4
SERVE_RESNET_BATCH = 32
BF16_PEAK_OPS_PER_S = 989e12
TOP_KERNELS = 5
# cuDNN's convolution kernels and layout transposes, by the profiler's
# names: the captured step must run the eager step's
CONV_KERNEL = re.compile(r"conv|cudnn|xmma|implicit|wgrad|dgrad|fprop|"
                         r"nchwToNhwc|nhwcToNchw", re.I)


def program_flops(main, batch):
    """Operations of one forward pass of ``main`` at ``batch`` rows,
    counted from its conv2d and mul ops' declared shapes (-1: the
    batch): 2 per multiply-add."""
    block = main.global_block()

    def shape(name):
        return [batch if s == -1 else int(s)
                for s in block._find_var_recursive(name).shape]

    total = 0
    for op in block.ops:
        if op.type in ("conv2d", "depthwise_conv2d"):
            out = shape(op.output("Output")[0])
            w = shape(op.input("Filter")[0])            # O, I/groups, kh, kw
            total += 2 * math.prod(out) * math.prod(w[1:])
        elif op.type == "mul":
            x, y = shape(op.input("X")[0]), shape(op.input("Y")[0])
            total += 2 * math.prod(x) * math.prod(
                y[op.attr("y_num_col_dims", 1):])
    return total


def fetch_losses(exe, main, feed, fetches, scope, n):
    """``n`` runs of ``main``: each run's first fetch as a float."""
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=fetches,
                                     scope=scope)[0]).reshape(-1)[0])
            for _ in range(n)]


def unequal(a, b):
    """The names of the scopes' tensors that differ anywhere."""
    return sorted(n for n in a.local_var_names()
                  if not torch.equal(a.find_var(n), b.find_var(n)))


def graphed_vs_eager(fluid, dev, main, feed, loss, scope, phase,
                     steps=CHECK_STEPS, **where):
    """``steps`` steps from clones of ``scope``: eager, eager again
    (whether the step is reproducible at all), graphed (run 1 eager, run
    2 captured, then replays). The losses and every persistable must
    equal eager's to the bit."""
    runs = {}
    for label, graphs in (("eager", False), ("eager_again", False),
                          ("graphed", True)):
        sc = clone_scope(fluid, scope)
        exe = fluid.Executor(dev, cuda_graphs=graphs)
        runs[label] = (fetch_losses(exe, main, feed, [loss], sc, steps),
                       sc)
        exe.close()
    eager_diff = unequal(runs["eager_again"][1], runs["eager"][1])
    graph_diff = unequal(runs["graphed"][1], runs["eager"][1])
    rec = dict(phase=phase, check="graphed_vs_eager", steps=steps,
               losses_graphed=runs["graphed"][0],
               losses_eager=runs["eager"][0],
               losses_eager_again=runs["eager_again"][0],
               eager_repeat_unequal=eager_diff[:8],
               eager_repeat_unequal_count=len(eager_diff),
               graphed_unequal=graph_diff[:8],
               graphed_unequal_count=len(graph_diff),
               persistables=len(scope.local_var_names()), **where)
    emit(**rec)
    del runs
    torch.cuda.empty_cache()
    if (eager_diff or graph_diff or rec["losses_graphed"] !=
            rec["losses_eager"] or rec["losses_eager_again"] !=
            rec["losses_eager"]):
        raise AssertionError("%s: graphed vs eager not equal to the bit: "
                             "%s" % (phase, rec))


def lenet_path(dev):
    """BASELINE config 1 as bench.py's bench_lenet feeds it: LeNet-5 at
    batch 1024, fp32, Adam, graphed, on one synthetic batch made on the
    card; graphed against eager from one state; then LENET_WINDOWS timed
    ``iters=LENET_ITERS`` windows after LENET_WARM single steps."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import lenet

    with fluid.unique_name.guard():
        main, startup, loss, acc = lenet.build_train_program()
    g = torch.Generator(device=dev).manual_seed(0)
    feed = {"img": torch.rand(LENET_BATCH, 1, 28, 28, generator=g,
                              device=dev),
            "label": torch.randint(0, 10, (LENET_BATCH, 1), generator=g,
                                   device=dev)}
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, "lenet")
    exe = fluid.Executor(dev)
    losses = fetch_losses(exe, main, feed, [loss, acc], scope, LENET_WARM)
    window_s, accs = [], []
    for _ in range(LENET_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj, accuracy = exe.run(main, feed=feed, fetch_list=[loss, acc],
                                 scope=scope, iters=LENET_ITERS)
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t0)
        losses.extend(np.asarray(traj).reshape(-1).tolist())
        accs.append(float(np.asarray(accuracy).reshape(-1)[-1]))
    step_s = statistics.median(window_s) / LENET_ITERS
    api, kern = host_launches(lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope, iters=10))
    exe.close()
    busy_ms = sum(us for us, _ in kern.values()) / 1e3 / 10
    flops = 3 * program_flops(main, LENET_BATCH)
    rec = dict(phase="lenet", config="LeNet-5 (BASELINE config 1)",
               batch=LENET_BATCH, dtype="float32", optimizer="Adam",
               mode="graphed", iters=LENET_ITERS, window_s=window_s,
               step_ms=step_s * 1e3, images_per_s=LENET_BATCH / step_s,
               device_busy_ms=busy_ms if kern else "not measured",
               idle_share=1.0 - busy_ms / (step_s * 1e3) if kern
               else "not measured",
               device_kernels_per_step=sum(n for _, n in kern.values()) / 10,
               host_launch_calls_per_step={k: v / 10
                                           for k, v in api.items()},
               top_kernels=[dict(name=k[:160], ms=us / 1e3 / 10,
                                 calls=n / 10) for k, (us, n) in sorted(
                   kern.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]],
               train_flops_per_step=flops,
               achieved_tflops=flops / step_s / 1e12,
               first_loss=losses[0], last_loss=losses[-1],
               accuracy=accs)
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("lenet: losses not finite and falling: %s"
                             % losses[::10])
    return rec


def resnet_program(fluid, resnet, fmt, depth=50, size=RESNET_SIZE,
                   use_amp=True, **kw):
    with fluid.unique_name.guard():
        return resnet.build_train_program(depth=depth, image_size=size,
                                          use_amp=use_amp, data_format=fmt,
                                          **kw)


def resnet_feed(dev, batch, size, seed, classes=RESNET_CLASSES):
    """Synthetic ``rand`` images and random labels, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"img": torch.rand(batch, 3, size, size, generator=g, device=dev),
            "label": torch.randint(0, classes, (batch, 1), generator=g,
                                   device=dev)}


def conv_kernels(kern):
    return sorted({k[:160] for k in kern if CONV_KERNEL.search(k)})


def resnet_round(fluid, dev, prog, feed, fmt):
    """One timed round of a layout (fresh scope, graphed): RESNET_WARM
    steps (the eager run and the capture), RESNET_TIMED timed replays, a
    traced replay. Returns (its record, the trained scope)."""
    main, startup, loss, _ = prog
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = fetch_losses(exe, main, feed, [loss], scope, RESNET_WARM)
    step_s = []
    for _ in range(RESNET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += fetch_losses(exe, main, feed, [loss], scope, 1)
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    api, kern, traced, _ = complete_trace(
        lambda: fetch_losses(exe, main, feed, [loss], scope, 1))
    exe.close()
    steady = statistics.median(step_s)
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    flops = 3 * program_flops(main, RESNET_BATCH)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    rec = dict(phase="resnet", check="step_times", layout=fmt,
               mode="graphed", step_s=step_s, step_ms=steady * 1e3,
               images_per_s=RESNET_BATCH / steady,
               device_busy_ms=busy_ms if kern else "not measured",
               idle_share=1.0 - busy_ms / (steady * 1e3) if kern
               else "not measured",
               device_kernels_per_step=sum(n for _, n in kern.values()),
               host_launch_calls_per_step=api,
               max_memory_allocated_gb=peak, memory_reserved_gb=reserved,
               top_kernels=[dict(name=k[:160], ms=us / 1e3, calls=n)
                            for k, (us, n) in top],
               train_flops_per_step=flops,
               mfu=flops / steady / BF16_PEAK_OPS_PER_S, losses=losses)
    emit(**rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("resnet (%s): a non-finite AMP loss: %s"
                             % (fmt, losses))
    return rec, scope


def float64_program(main):
    """``main`` with every float32 var and fill made float64, in every
    block."""
    from paddle_tpu_torch.fluid import framework

    desc = main.to_desc()
    for blk in desc["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "float32":
                v["dtype"] = "float64"
        for op in blk["ops"]:
            if op["attrs"].get("dtype") == "float32":
                op["attrs"]["dtype"] = "float64"
    return framework.Program.from_desc(desc)


def card_vs_cpu(fluid, dev, main, loss, cpu, feeds, wide):
    """``main`` a step a feed from the CPU scope ``cpu``'s state: graphed
    on the card, on the CPU, and on the CPU in float64 (``wide(feed)``
    is the float64 program's feed). Returns each step's (card, CPU,
    float64) loss and rows (card vs CPU, CPU vs float64, step, name,
    card vs CPU, CPU vs float64): the loss's relative difference, twice;
    each persistable's largest difference over its largest float64
    magnitude, then the L2 norm of the difference over the L2 norm of
    what the float64 run moved it since the start."""
    card, c64 = fluid.Scope(), fluid.Scope()
    begin = {}
    for n in cpu.local_var_names():
        t = cpu.find_var(n)
        card.set_var(n, t.to(dev, copy=True))
        c64.set_var(n, t.double() if t.dtype == torch.float32 else t.clone())
        begin[n] = t.to(torch.float64, copy=True)
    m64 = float64_program(main)
    cexe, gexe = fluid.Executor("cpu"), fluid.Executor(dev)
    losses, rows = [], []
    for step, f in enumerate(feeds):
        got = fetch_losses(gexe, main, f, [loss], card, 1)[0]
        want = fetch_losses(cexe, main, f, [loss], cpu, 1)[0]
        truth = fetch_losses(cexe, m64, wide(f), [loss.name], c64, 1)[0]
        losses.append((got, want, truth))
        rel = (abs(got - want) / abs(want), abs(want - truth) / abs(truth))
        rows.append(rel + (step, "loss") + rel)
        for n in cpu.local_var_names():
            w, t = cpu.find_var(n).double(), c64.find_var(n).double()
            scale = max(t.abs().max().item(), 1e-30)
            moved = max((t - begin[n]).norm().item(), 1e-30)
            d = (card.find_var(n).cpu().double() - w, w - t)
            rows.append(tuple(x.abs().max().item() / scale for x in d) + (
                step, n) + tuple(x.norm().item() / moved for x in d))
    gexe.close()
    return losses, rows


def card_vs_cpu_record(losses, rows, rtol, state_steps=None,
                       update_rtol=None, **where):
    """The record of ``card_vs_cpu``'s readings; ``over`` lists the
    rows past max(rtol, 3 x the fp32 noise): every loss, and the
    persistables after the first ``state_steps`` steps (all by
    default). A later persistable is judged by its L2 difference over
    what it moved instead, against max(update_rtol, 3 x the CPU's own
    against float64)."""
    judged = [r for r in rows if r[3] == "loss" or state_steps is None
              or r[2] < state_steps]
    over = [r for r in judged if r[0] > max(rtol, 3 * r[1])]
    worst = max(judged)
    later = [r for r in rows if r not in judged]
    if later:
        most = max(later, key=lambda r: r[4])
        over += [r for r in later if r[4] > max(update_rtol, 3 * r[5])]
        where = dict(where, state_steps=state_steps,
                     later_state_max_rel=max(r[0] for r in later),
                     later_update_rel_l2=most[4],
                     later_update_rel_l2_noise=most[5],
                     later_update_rel_l2_at=[most[2], most[3]],
                     update_rtol=update_rtol)
    return dict(where, check="card_vs_cpu", steps=len(losses),
                losses_card=[x[0] for x in losses],
                losses_cpu=[x[1] for x in losses],
                losses_cpu_float64=[x[2] for x in losses],
                loss_rel=max(r[0] for r in rows if r[3] == "loss"),
                max_rel=worst[0], max_rel_fp32_noise=worst[1],
                max_rel_at=[worst[2], worst[3]],
                past_rtol=sum(r[0] > rtol for r in rows),
                compared=len(judged), over=[list(r) for r in over[:8]],
                rtol=rtol)


def resnet_card_vs_cpu(fluid, resnet, dev):
    """ResNet-18, fp32, CARD_CPU_SIZE, batch CARD_CPU_BATCH, CHECK_STEPS
    steps (a fresh seeded batch each) from one startup state, graphed on
    the card against the port's CPU path. The CPU also runs the program
    in float64, which measures how far fp32 rounding alone moves each
    quantity here (``noise``: a random-label ResNet's gradients are
    ill-conditioned in fp32, its velocities moving by up to 40% of their
    largest magnitude within 3 steps at this shape, its losses by 1e-4).
    After every step each loss (relative) and each persistable (over its
    largest magnitude) on the card must lie within max(CARD_CPU_RTOL, 3 x
    noise) of the CPU's; the largest difference is printed."""
    main, startup, loss, _ = resnet_program(
        fluid, resnet, "NCHW", depth=18, size=CARD_CPU_SIZE, use_amp=False,
        lr=0.01)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    rng = np.random.RandomState(1)
    feeds = [{"img": rng.rand(CARD_CPU_BATCH, 3, CARD_CPU_SIZE,
                              CARD_CPU_SIZE).astype(np.float32),
              "label": rng.randint(0, RESNET_CLASSES, (CARD_CPU_BATCH, 1))
              .astype(np.int64)} for _ in range(CHECK_STEPS)]
    losses, rows = card_vs_cpu(
        fluid, dev, main, loss, cpu, feeds,
        lambda f: dict(f, img=f["img"].astype(np.float64)))
    rec = card_vs_cpu_record(losses, rows, CARD_CPU_RTOL, phase="resnet",
                             depth=18, image_size=CARD_CPU_SIZE,
                             batch=CARD_CPU_BATCH, dtype="float32")
    emit(**rec)
    if rec["over"]:
        raise AssertionError("resnet: card vs CPU past max(%g, 3 x fp32 "
                             "noise): %s" % (CARD_CPU_RTOL, rec))


def resnet_serving(fluid, resnet, inference, dev, scope):
    """``resnet.build_infer_program(depth=50)`` saved with the trained
    ``scope``'s weights and served by a Predictor at batch
    SERVE_RESNET_BATCH (run 1 eager, run 2 captured, then replays):
    logits within SERVE_ATOL of an eager run of the for_test clone."""
    import tempfile

    with fluid.unique_name.guard():
        main, _, logits = resnet.build_infer_program(depth=50)
    feed = {"img": np.random.RandomState(7).rand(
        SERVE_RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE).astype(np.float32)}
    eager = fluid.Executor(dev, cuda_graphs=False)
    want = eager.run(main.clone(for_test=True), feed=feed,
                     fetch_list=[logits], scope=scope)[0]
    with tempfile.TemporaryDirectory() as model_dir:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(model_dir, ["img"], [logits], eager,
                                          main_program=main)
        pred = inference.create_predictor(inference.Config(model_dir))
        run_s, outs = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            outs.append(pred.run(feed)[0])
            run_s.append(time.perf_counter() - t0)
    err = max(float(np.abs(o - want).max()) for o in outs)
    steady = statistics.median(run_s[2:])
    rec = dict(phase="resnet", check="serving", depth=50,
               batch=SERVE_RESNET_BATCH, dtype="float32", run_s=run_s,
               request_ms=steady * 1e3,
               images_per_s=SERVE_RESNET_BATCH / steady,
               logits_shape=list(outs[-1].shape),
               vs_eager_max_abs_err=err, atol=SERVE_ATOL,
               logits_max_abs=float(np.abs(want).max()))
    emit(**rec)
    if not (outs[-1].shape == (SERVE_RESNET_BATCH, RESNET_CLASSES) and
            all(np.isfinite(o).all() for o in outs) and err <= SERVE_ATOL):
        raise AssertionError("resnet serving: %s" % rec)


def resnet_path(inference, dev):
    """BASELINE config 2 as bench.py's bench_resnet feeds it: ResNet-50,
    batch 256, 224x224, use_amp=True, Momentum(0.9) + L2Decay(1e-4),
    synthetic images and labels made on the card. Per layout (NCHW, the
    reference's default, and NHWC): graphed against eager from one
    state, and the convolution kernels of the eager step and of a traced
    replay by name; then RESNET_ROUNDS timed rounds in turns; the card
    against the CPU (``resnet_card_vs_cpu``); serving
    (``resnet_serving``)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    feed = resnet_feed(dev, RESNET_BATCH, RESNET_SIZE, seed=0)
    progs = {}
    for fmt in ("NCHW", "NHWC"):
        t0 = time.perf_counter()
        progs[fmt] = prog = resnet_program(fluid, resnet, fmt)
        main, startup, loss, _ = prog
        build_s = time.perf_counter() - t0
        scope = fluid.Scope()
        fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
        graphed_vs_eager(fluid, dev, main, feed, loss, scope, "resnet",
                         layout=fmt, build_s=build_s)
        exe, sc = fluid.Executor(dev), clone_scope(fluid, scope)
        _, eager_kern = host_launches(
            lambda: fetch_losses(exe, main, feed, [loss], sc, 1))
        fetch_losses(exe, main, feed, [loss], sc, 1)       # the capture
        _, replay_kern, _, _ = complete_trace(
            lambda: fetch_losses(exe, main, feed, [loss], sc, 1))
        exe.close()
        del sc, scope
        torch.cuda.empty_cache()
        eager_conv, replay_conv = (conv_kernels(eager_kern),
                                   conv_kernels(replay_kern))
        emit(phase="resnet", check="conv_kernels", layout=fmt,
             eager=eager_conv, replay_equal=replay_conv == eager_conv,
             replay_only=sorted(set(replay_conv) - set(eager_conv)),
             eager_only=sorted(set(eager_conv) - set(replay_conv)))
        if not eager_conv or replay_conv != eager_conv:
            raise AssertionError("resnet (%s): the replay's convolution "
                                 "kernels are not the eager step's" % fmt)
    rounds, trained = {}, None
    for fmt in RESNET_ROUNDS:
        rec, trained = resnet_round(fluid, dev, progs[fmt], feed, fmt)
        rounds.setdefault(fmt, []).append(rec)
        torch.cuda.empty_cache()
    emit(phase="resnet", check="layouts_compare", batch=RESNET_BATCH,
         image_size=RESNET_SIZE, amp="bf16",
         step_ms={f: [r["step_ms"] for r in rs] for f, rs in rounds.items()},
         images_per_s={f: [r["images_per_s"] for r in rs]
                       for f, rs in rounds.items()},
         idle_share={f: [r["idle_share"] for r in rs]
                     for f, rs in rounds.items()},
         mfu={f: [r["mfu"] for r in rs] for f, rs in rounds.items()})
    resnet_card_vs_cpu(fluid, resnet, dev)
    resnet_serving(fluid, resnet, inference, dev, trained)
    del trained
    torch.cuda.empty_cache()
    return rounds


# -- DeepFM, BASELINE config 4: the sparse embedding engine's device tier ----
DEEPFM_BATCH = 4096                # bench.py's bench_deepfm
DEEPFM_WARM, DEEPFM_TIMED = 2, 20
DEEPFM_ITERS, DEEPFM_WINDOWS = 100, 3
DEEPFM_SPARSE_DENSE_STEPS = 5
# the reference's own tolerance between its sparse and dense DeepFM runs
# (tests/test_sparse.py); on one repeated batch the untouched rows keep
# zero moments either way, so the two differ by rounding alone
DEEPFM_SPARSE_DENSE_RTOL = 2e-3
# and every persistable, over its largest magnitude (1.26e-6 on the H100)
DEEPFM_SPARSE_DENSE_STATE_RTOL = 1e-4
# card vs CPU: as the resnet check, max(rtol, 3 x the fp32 noise); from
# step 2 on, each tensor's L2 difference over the L2 norm of its update
# (at most 6.1e-4 after step 2 and 2.5e-3 after step 3 on the H100)
DEEPFM_CPU_RTOL = 1e-4
DEEPFM_CPU_UPDATE_RTOL = 1e-2
# the served pred against the training program's: the same fp32 ops
# (TF32 off) on the same card
DEEPFM_SERVE_ATOL = 1e-6


def deepfm_program(fluid, deepfm, is_sparse=True):
    with fluid.unique_name.guard():
        return deepfm.build_train_program(deepfm.DeepFMConfig(),
                                          is_sparse=is_sparse)


def deepfm_feed(deepfm, batch, seed, dev=None):
    """``deepfm.synthetic_batch`` at the full config, on ``dev`` (numpy
    when None)."""
    f = deepfm.synthetic_batch(deepfm.DeepFMConfig(), batch, seed=seed)
    return f if dev is None else {k: torch.from_numpy(v).to(dev)
                                  for k, v in f.items()}


def vocab_sized_outputs(fn, vocab, scope):
    """The aten ops of one call of ``fn`` whose output has ``vocab`` rows
    and does not alias a tensor of ``scope`` (a table or an accumulator
    updated in place): a dense [vocab, dim] gradient would be one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    own = {scope.find_var(n).untyped_storage().data_ptr()
           for n in scope.local_var_names()}
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dim() and \
                        t.shape[0] == vocab and \
                        t.untyped_storage().data_ptr() not in own:
                    seen.append(str(func))
            return out

    with Spy():
        fn()
    return seen


def sparse_tables(main):
    """{table: [its accumulators]} of the program's sparse lookups'
    tables, from their optimizer ops."""
    from paddle_tpu_torch.embedding import find_sparse_lookup_ops

    tables = {op.input("W")[0] for op in find_sparse_lookup_ops(main)}
    return {op.input("Param")[0]: [n for slot, names in op.inputs.items()
                                   for n in names
                                   if slot.startswith(("Moment",
                                                       "Velocity"))]
            for op in main.global_block().ops
            if op.input("Param") and op.input("Param")[0] in tables}


def deepfm_sparse_step(fluid, dev, main, feed, loss, scope, vocab):
    """One eager sparse step from a clone of ``scope``: the SelectedRows
    gradients' shapes, and no aten op making a [vocab, ...] tensor
    (``vocab_sized_outputs``); then CHECK_STEPS graphed steps from another
    clone (eager, captured, replayed): the rows the batch does not touch
    keep their values and their moments to the bit, and every touched
    row of a table moved."""
    sc = clone_scope(fluid, scope)
    exe = fluid.Executor(dev, cuda_graphs=False)
    names = sorted(sparse_tables(main))
    grads = [n + "@GRAD" for n in names]
    out = []
    dense = vocab_sized_outputs(lambda: out.extend(exe.run(
        main, feed=feed, fetch_list=grads + [n + "@ROWS" for n in grads],
        scope=sc, return_numpy=False)), vocab, sc)
    shapes = {n: list(t.shape) for n, t in zip(grads + [
        n + "@ROWS" for n in grads], out)}
    del sc, out
    sc = clone_scope(fluid, scope)
    gexe = fluid.Executor(dev)
    fetch_losses(gexe, main, feed, [loss], sc, CHECK_STEPS)
    gexe.close()
    touched = torch.zeros(vocab, dtype=torch.bool, device=dev)
    touched[feed["sparse_ids"].reshape(-1)] = True
    moved_untouched, frozen_touched = [], {}
    for table, slots in sparse_tables(main).items():
        for n in [table] + slots:
            if not torch.equal(sc.find_var(n)[~touched],
                               scope.find_var(n)[~touched]):
                moved_untouched.append(n)
        still = (sc.find_var(table)[touched] ==
                 scope.find_var(table)[touched]).all(dim=1)
        frozen_touched[table] = int(still.sum())
    n_rows = feed["sparse_ids"].numel()
    rec = dict(phase="deepfm", check="sparse_step", grad_shapes=shapes,
               vocab_sized_ops=dense[:8], vocab_sized_count=len(dense),
               rows_touched=int(touched.sum()), vocab=vocab,
               untouched_moved=moved_untouched,
               touched_rows_unmoved=frozen_touched, steps=CHECK_STEPS)
    emit(**rec)
    bad = [n for n in grads if shapes[n][0] != n_rows or
           shapes[n + "@ROWS"] != [n_rows]]
    if dense or moved_untouched or bad or any(frozen_touched.values()):
        raise AssertionError("deepfm: SelectedRows step: %s" % rec)


def deepfm_sparse_vs_dense(fluid, deepfm, dev, scope, feed):
    """DEEPFM_SPARSE_DENSE_STEPS graphed steps of the sparse and the
    dense program on one batch from one state: losses within
    DEEPFM_SPARSE_DENSE_RTOL, falling, and every persistable within
    DEEPFM_SPARSE_DENSE_STATE_RTOL of its largest magnitude."""
    got = {}
    for sparse in (True, False):
        main, _, loss, _ = deepfm_program(fluid, deepfm, is_sparse=sparse)
        sc, exe = clone_scope(fluid, scope), fluid.Executor(dev)
        got[sparse] = (fetch_losses(exe, main, feed, [loss], sc,
                                    DEEPFM_SPARSE_DENSE_STEPS), sc)
        exe.close()
    (ls, ss), (ld, sd) = got[True], got[False]
    gap = max(abs(a - b) / abs(b) for a, b in zip(ls, ld))
    state_gap = max(rel_diff(ss.find_var(n), sd.find_var(n))
                    for n in ss.local_var_names())
    rec = dict(phase="deepfm", check="sparse_vs_dense",
               steps=DEEPFM_SPARSE_DENSE_STEPS, losses_sparse=ls,
               losses_dense=ld, loss_max_rel_gap=gap,
               persistable_max_rel_gap=state_gap,
               rtol=DEEPFM_SPARSE_DENSE_RTOL,
               state_rtol=DEEPFM_SPARSE_DENSE_STATE_RTOL)
    emit(**rec)
    if not (gap <= DEEPFM_SPARSE_DENSE_RTOL and ls[-1] < ls[0] and
            state_gap <= DEEPFM_SPARSE_DENSE_STATE_RTOL):
        raise AssertionError("deepfm: sparse vs dense: %s" % rec)


def deepfm_card_vs_cpu(fluid, deepfm, dev, scope):
    """The full config at DEEPFM_BATCH, CHECK_STEPS steps (a fresh seeded
    batch each) from the card's startup state: graphed on the card
    against the port's CPU path and its float64 run (``card_vs_cpu``).
    Every loss, and every persistable after the first step (tables,
    Adam moments, MLP), within max(DEEPFM_CPU_RTOL, 3 x the fp32 noise);
    after later steps, each persistable's L2 difference over the L2 norm
    of what it moved within max(DEEPFM_CPU_UPDATE_RTOL, 3 x the CPU's
    own against float64). A relu input within rounding of 0 can take
    the other sign on the card, and then that example's gradient goes
    another way: from step 2 on, a few elements part by up to a share of
    lr while the rest agree (tools/deepfm_divergence.py; PERF.md §6)."""
    main, _, loss, _ = deepfm_program(fluid, deepfm)
    cpu = fluid.Scope()
    for n in scope.local_var_names():
        cpu.set_var(n, scope.find_var(n).cpu())
    feeds = [deepfm_feed(deepfm, DEEPFM_BATCH, seed=11 + i)
             for i in range(CHECK_STEPS)]
    losses, rows = card_vs_cpu(
        fluid, dev, main, loss, cpu, feeds,
        lambda f: dict(f, dense_x=f["dense_x"].astype(np.float64)))
    rec = card_vs_cpu_record(losses, rows, DEEPFM_CPU_RTOL, state_steps=1,
                             update_rtol=DEEPFM_CPU_UPDATE_RTOL,
                             phase="deepfm", batch=DEEPFM_BATCH,
                             dtype="float32")
    emit(**rec)
    if rec["over"]:
        raise AssertionError("deepfm: card vs CPU past max(%g, 3 x fp32 "
                             "noise): %s" % (DEEPFM_CPU_RTOL, rec))


def deepfm_timing(fluid, dev, main, feed, loss, scope):
    """From a clone of ``scope``: DEEPFM_TIMED eager steps (after
    DEEPFM_WARM) and a traced one; the same graphed (the warm steps run
    eagerly and capture), TRACE_TRIES traced replays; then DEEPFM_WINDOWS
    ``iters=DEEPFM_ITERS`` windows. Step ms (median), examples/s, device
    busy ms and idle share, device kernels and host launch calls a step,
    peak allocated GB."""
    sc = clone_scope(fluid, scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = dict(phase="deepfm", check="step_times", batch=DEEPFM_BATCH,
               config="DeepFM (BASELINE config 4), is_sparse=True, Adam "
                      "lr 1e-3")
    losses = []
    for mode, graphs in (("eager", False), ("graphed", True)):
        exe = fluid.Executor(dev, cuda_graphs=graphs)
        losses += fetch_losses(exe, main, feed, [loss], sc, DEEPFM_WARM)
        step_s = []
        for _ in range(DEEPFM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += fetch_losses(exe, main, feed, [loss], sc, 1)
            step_s.append(time.perf_counter() - t0)
        api, kern, totals, _ = complete_trace(
            lambda: fetch_losses(exe, main, feed, [loss], sc, 1))
        steady = statistics.median(step_s)
        busy_ms = sum(us for us, _ in kern.values()) / 1e3
        rec[mode] = dict(
            step_ms=steady * 1e3, step_ms_all=[t * 1e3 for t in step_s],
            examples_per_s=DEEPFM_BATCH / steady,
            device_busy_ms=busy_ms if kern else "not measured",
            idle_share=1.0 - busy_ms / (steady * 1e3) if kern
            else "not measured",
            device_kernels_per_step=sum(n for _, n in kern.values()),
            kernels_per_trace=totals, host_launch_calls_per_step=api,
            top_kernels=[dict(name=k[:120], ms=us / 1e3, calls=n)
                         for k, (us, n) in sorted(
                             kern.items(), key=lambda kv: -kv[1][0])[
                                 :TOP_KERNELS]])
        if graphs:
            window_s = []
            for _ in range(DEEPFM_WINDOWS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                traj = exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                               iters=DEEPFM_ITERS)[0]
                torch.cuda.synchronize()
                window_s.append(time.perf_counter() - t0)
                losses += np.asarray(traj).reshape(-1).tolist()
            step = statistics.median(window_s) / DEEPFM_ITERS
            rec["iters_windows"] = dict(
                iters=DEEPFM_ITERS, window_s=window_s, step_ms=step * 1e3,
                examples_per_s=DEEPFM_BATCH / step)
        exe.close()
    rec.update(max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30, first_loss=losses[0], last_loss=losses[-1],
               steps=len(losses))
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("deepfm: losses not finite and falling: %s"
                             % losses[::20])
    return rec, sc


def deepfm_serving(fluid, inference, dev, prog, scope, feed):
    """The trained ``pred`` saved with save_inference_model (fed
    sparse_ids and dense_x) and served by a Predictor at DEEPFM_BATCH
    (run 1 eager, run 2 captured, then replays), against the ``pred`` a
    training step computes from the same state (a clone of ``scope``),
    within DEEPFM_SERVE_ATOL."""
    import tempfile

    main, _, _, pred = prog
    eager = fluid.Executor(dev, cuda_graphs=False)
    want = eager.run(main, feed=feed, fetch_list=[pred],
                     scope=clone_scope(fluid, scope))[0]
    served = {k: feed[k].cpu().numpy() for k in ("sparse_ids", "dense_x")}
    with tempfile.TemporaryDirectory() as model_dir:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(model_dir, list(served), [pred],
                                          eager, main_program=main)
        predictor = inference.create_predictor(
            inference.Config(model_dir, place=dev))
        ops = [op.type for op in predictor.program.global_block().ops]
        run_s, outs = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            outs.append(predictor.run(served)[0])
            run_s.append(time.perf_counter() - t0)
    err = max(float(np.abs(o - want).max()) for o in outs)
    steady = statistics.median(run_s[2:])
    rec = dict(phase="deepfm", check="serving", batch=DEEPFM_BATCH,
               run_s=run_s, request_ms=steady * 1e3,
               examples_per_s=DEEPFM_BATCH / steady,
               pred_shape=list(outs[-1].shape), vs_program_max_abs_err=err,
               atol=DEEPFM_SERVE_ATOL, lookups=ops.count("embedding_lookup"),
               backward_ops=[t for t in ops if t in ("autodiff", "adam")])
    emit(**rec)
    if not (outs[-1].shape == (DEEPFM_BATCH, 1) and rec["lookups"] == 2 and
            not rec["backward_ops"] and
            all(np.isfinite(o).all() for o in outs) and
            err <= DEEPFM_SERVE_ATOL):
        raise AssertionError("deepfm serving: %s" % rec)


def deepfm_path(A, inference, dev):
    """BASELINE config 4 as bench.py's bench_deepfm feeds it:
    ``build_train_program(DeepFMConfig())``, is_sparse=True, Adam lr
    1e-3, batch 4096, one synthetic batch on the card, the port's seeded
    startup. Graphed against eager from one state (``graphed_vs_eager``);
    the SelectedRows step (``deepfm_sparse_step``); sparse against dense;
    the card against the CPU; step times eager, graphed and in
    ``iters=k`` windows; the trained ``pred`` served. None of the 14
    attention kernels runs here (their counts stay 0): the reference
    reaches no ``pallas_call`` on this path (``jnp.unique``,
    ``jnp.take``, scatter-adds), so the ops lower to torch's own
    calls."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import deepfm

    reset_launches(A)
    t0 = time.perf_counter()
    prog = main, startup, loss, _ = deepfm_program(fluid, deepfm)
    build_s = time.perf_counter() - t0
    vocab = deepfm.DeepFMConfig().sparse_feature_dim
    feed = deepfm_feed(deepfm, DEEPFM_BATCH, seed=0, dev=dev)
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, "deepfm",
                     build_s=build_s)
    deepfm_sparse_step(fluid, dev, main, feed, loss, scope, vocab)
    deepfm_sparse_vs_dense(fluid, deepfm, dev, scope, feed)
    deepfm_card_vs_cpu(fluid, deepfm, dev, scope)
    torch.cuda.empty_cache()
    rec, trained = deepfm_timing(fluid, dev, main, feed, loss, scope)
    deepfm_serving(fluid, inference, dev, prog, trained, feed)
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    emit(phase="deepfm", check="attention_launches", launches=attention,
         phase_s=time.perf_counter() - t0)
    if any(attention.values()):
        raise AssertionError("deepfm: an attention kernel ran: %s"
                             % attention)
    del trained, scope
    torch.cuda.empty_cache()
    return rec


# -- host_embedding: the host tier and dataset feeding (bench.py:677) --------
# bench.py's bench_embedding shape: a vocabulary 16x a 4096-row budget
HOST_BENCH = dict(vocab=65536, budget=4096, batch=256, fields=8, dense=8,
                  dim=16, fc=(64, 64), steps=30, grown_steps=3)
# config 4's widths with the distinct categorical values of the Criteo
# Kaggle display-advertising set (DLRM's Kaggle setting) as the
# vocabulary, behind a 262,144-row cache
HOST_FULL_ROWS = 33762577
HOST_FULL_BUDGET = 262144
HOST_FULL_WARM, HOST_FULL_TIMED, HOST_FULL_TRACED = 5, 20, 3
# host tier against device tier: config 4's own vocabulary
HOST_VS_DEVICE = dict(batch=1024, budget=32768, steps=10)
HOST_VS_DEVICE_RTOL = 1e-6
# train_from_dataset: config-4 samples, a vocabulary 10x the budget
HOST_DATASET = dict(vocab=1000000, budget=131072, batch=4096, batches=8)


def host_cfg(deepfm, vocab, fields=26, dense=13, dim=10,
             fc=(400, 400, 400)):
    return deepfm.DeepFMConfig(sparse_feature_dim=vocab, num_fields=fields,
                               num_dense=dense, embedding_size=dim,
                               fc_sizes=fc)


def host_program(fluid, deepfm, embedding, cfg, budget, seed=1, init=None):
    """A fresh HostEmbeddingTable "fm_emb" (``init`` loaded when given)
    and the DeepFM program with fm_emb on it: (table, main, startup,
    loss)."""
    embedding.reset_tables()
    table = embedding.HostEmbeddingTable(
        "fm_emb", num_rows=cfg.sparse_feature_dim, dim=cfg.embedding_size,
        resident_budget=budget, seed=seed)
    if init is not None:
        table.load(init)
    with fluid.unique_name.guard():
        main, startup, loss, _ = deepfm.build_train_program(
            cfg, residence="host")
    return table, main, startup, loss


def host_series(monitor):
    """The host tier's and the executor's series this phase reads."""
    h = monitor.histogram("embedding_lookup_seconds",
                          labels={"table": "fm_emb"})
    get = {n: monitor.counter(n, labels={"table": "fm_emb"}).value for n in (
        "embedding_prefetch_hit_total", "embedding_prefetch_miss_total",
        "embedding_evictions_total")}
    get.update({n: monitor.counter(n).value for n in (
        "executor_graph_capture_total", "executor_compile_cache_miss_total",
        "executor_graph_state_copy_total", "executor_graph_replay_total")})
    return h, get


@contextlib.contextmanager
def lookup_times(table):
    """Each ``table.prepare`` call's host seconds, in a list: the span
    embedding_lookup_seconds observes, read exactly (the histogram's
    buckets are a factor of 4 apart) and for this window alone."""
    samples, prepare = [], table.prepare

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return prepare(*args, **kwargs)
        finally:
            samples.append(time.perf_counter() - t0)

    table.prepare = timed
    try:
        yield samples
    finally:
        del table.prepare


def quantiles_ms(samples):
    return dict(p50_ms=float(np.percentile(samples, 50)) * 1e3,
                p99_ms=float(np.percentile(samples, 99)) * 1e3,
                max_ms=max(samples) * 1e3, n=len(samples)) \
        if samples else "not measured"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def series_delta(before, after):
    return {k: after[k] - before[k] for k in before}


def host_bench(fluid, deepfm, embedding, monitor, dev):
    """bench.py's bench_embedding on the card: fresh uniform ids every
    step, 3 warm steps (eager, capture, replay), 30 steps without
    prefetch and 30 with ``embedding.prefetch(main, next_feed)`` after
    each, steps/s both ways, lookup p50/p99; then grow(2 x vocab) and 3
    more steps (ids inside the first range, as bench.py: fm_w1 shares
    the feed and stays on the device) with no new capture and no new
    compile-cache miss."""
    b = HOST_BENCH
    cfg = host_cfg(deepfm, b["vocab"], b["fields"], b["dense"], b["dim"],
                   b["fc"])
    table, main, startup, loss = host_program(fluid, deepfm, embedding, cfg,
                                              b["budget"])
    rng = np.random.RandomState(0)

    def fresh():
        return {"sparse_ids": rng.randint(0, b["vocab"], (
                    b["batch"], b["fields"])).astype(np.int64),
                "dense_x": rng.rand(b["batch"], b["dense"]).astype(
                    np.float32),
                "label": rng.randint(0, 2, (b["batch"], 1)).astype(np.int64)}

    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    losses = []

    def timed(n, prefetch):
        feeds = [fresh() for _ in range(n + 1)]
        sync(dev)
        with lookup_times(table) as lookups:
            t0 = time.perf_counter()
            for i in range(n):
                lv = exe.run(main, feed=feeds[i], fetch_list=[loss],
                             scope=scope, return_numpy=False)[0]
                if prefetch:
                    embedding.prefetch(main, feeds[i + 1])
            losses.append(float(lv.reshape(-1)[0]))
            wall = time.perf_counter() - t0
        return n / wall, quantiles_ms(lookups[1:] if prefetch else lookups)

    # warm: the first run (eager), the capture, then both modes once (the
    # side stream, the pinned host blocks and the staged rows' first use)
    timed(3, False)
    timed(3, True)
    h, before = host_series(monitor)
    lookups0 = h.count
    sps_cold, lookup_cold = timed(b["steps"], False)
    sps, lookup = timed(b["steps"], True)
    _, warm = host_series(monitor)
    table.grow(2 * b["vocab"])
    for _ in range(b["grown_steps"]):
        losses += fetch_losses(exe, main, fresh(), [loss], scope, 1)
    table.close()
    _, after = host_series(monitor)
    moved, grown = series_delta(before, warm), series_delta(warm, after)
    rec = dict(phase="host_embedding", check="bench_shape", **{
        k: v for k, v in b.items() if k != "fc"}, fc=list(b["fc"]),
        steps_per_s=sps, steps_per_s_no_prefetch=sps_cold,
        examples_per_s=sps * b["batch"],
        examples_per_s_no_prefetch=sps_cold * b["batch"],
        lookup=lookup, lookup_no_prefetch=lookup_cold,
        lookup_seconds_histogram=dict(
            p50_ms=1e3 * (h.quantile(0.5) or 0),
            p99_ms=1e3 * (h.quantile(0.99) or 0), count=h.count,
            window_count=h.count - lookups0),
        prefetch_hits=moved["embedding_prefetch_hit_total"],
        prefetch_misses=moved["embedding_prefetch_miss_total"],
        evictions=moved["embedding_evictions_total"],
        state_copies=moved["executor_graph_state_copy_total"],
        after_grow=dict(rows=table.num_rows, **grown),
        first_loss=losses[0], last_loss=losses[-1])
    emit(**rec)
    exe.close()
    if not (rec["prefetch_hits"] > 0 and rec["evictions"] > 0 and
            not rec["state_copies"] and
            not grown["executor_graph_capture_total"] and
            not grown["executor_compile_cache_miss_total"] and
            grown["executor_graph_replay_total"] == b["grown_steps"] and
            all(math.isfinite(x) for x in losses)):
        raise AssertionError("host_embedding: bench shape: %s" % rec)
    return rec


def host_full(fluid, deepfm, embedding, monitor, dev):
    """Config 4's widths at batch 4096 (106,496 ids a step) with fm_emb
    on a table of HOST_FULL_ROWS rows behind HOST_FULL_BUDGET: LRU
    eviction from step 3. HOST_FULL_WARM steps, then HOST_FULL_TIMED
    graphed steps with prefetch: steps/s, examples/s, lookup p50/p99,
    evictions a step, the prefetch hit share, the idle share of a trace
    of HOST_FULL_TRACED steps, peak device GB, host store GB."""
    cfg = host_cfg(deepfm, HOST_FULL_ROWS)
    t0 = time.perf_counter()
    table, main, startup, loss = host_program(fluid, deepfm, embedding, cfg,
                                              HOST_FULL_BUDGET)
    build_s = time.perf_counter() - t0
    # each step prefetches the next step's batch
    n = HOST_FULL_WARM + HOST_FULL_TIMED + 1 + HOST_FULL_TRACED + 1
    feeds = [deepfm.synthetic_batch(cfg, DEEPFM_BATCH, seed=100 + i)
             for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope = fluid.Executor(dev), fluid.Scope()
    exe.run(startup, scope=scope)
    h, before = host_series(monitor)
    lookups0 = h.count
    losses, i = [], 0

    prefetch_s, run_s = [], []

    def step():
        nonlocal i
        t = time.perf_counter()
        lv = exe.run(main, feed=feeds[i], fetch_list=[loss], scope=scope,
                     return_numpy=False)[0]
        t1 = time.perf_counter()
        embedding.prefetch(main, feeds[i + 1])
        prefetch_s.append(time.perf_counter() - t1)
        run_s.append(t1 - t)
        i += 1
        return lv

    for _ in range(HOST_FULL_WARM):
        losses.append(float(step().reshape(-1)[0]))
    _, warm = host_series(monitor)
    del prefetch_s[:], run_s[:]
    torch.cuda.synchronize()
    with lookup_times(table) as lookups:
        t1 = time.perf_counter()
        for _ in range(HOST_FULL_TIMED):
            step()
        losses.append(float(step().reshape(-1)[0]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    window_run, window_prefetch = list(run_s), list(prefetch_s)
    timed = HOST_FULL_TIMED + 1
    _, after = host_series(monitor)
    moved = series_delta(warm, after)
    api, kern, _, _ = complete_trace(
        lambda: [step() for _ in range(HOST_FULL_TRACED)], tries=1)
    table.close()
    busy_ms = sum(us for us, _ in kern.values()) / 1e3 / HOST_FULL_TRACED
    step_ms = 1e3 * wall / timed
    hits = moved["embedding_prefetch_hit_total"]
    store_gb = (table._values.nbytes + sum(
        a.nbytes for a in table._slot_stores.values())) / 1e9
    rec = dict(phase="host_embedding", check="full_width",
               rows=HOST_FULL_ROWS, budget=HOST_FULL_BUDGET,
               batch=DEEPFM_BATCH, ids_per_step=DEEPFM_BATCH * cfg.num_fields,
               fields=cfg.num_fields, dense=cfg.num_dense,
               dim=cfg.embedding_size, fc=list(cfg.fc_sizes),
               build_s=build_s, step_ms=step_ms,
               steps_per_s=1e3 / step_ms,
               examples_per_s=1e3 * DEEPFM_BATCH / step_ms,
               lookup=quantiles_ms(lookups),
               run_call=quantiles_ms(window_run),
               prefetch_call=quantiles_ms(window_prefetch),
               run_ms_all=[s * 1e3 for s in window_run],
               lookups=h.count - lookups0,
               evictions_per_step=moved["embedding_evictions_total"] / timed,
               prefetch_hit_share=hits / max(1, hits + moved[
                   "embedding_prefetch_miss_total"]),
               replays=moved["executor_graph_replay_total"],
               state_copies=moved["executor_graph_state_copy_total"],
               device_busy_ms=busy_ms if kern else "not measured",
               idle_share=1.0 - busy_ms / step_ms if kern
               else "not measured",
               host_launch_calls_per_step={
                   k: v / HOST_FULL_TRACED for k, v in api.items()},
               top_kernels=[dict(name=k[:100], ms=us / 1e3 /
                                 HOST_FULL_TRACED, calls=c)
                            for k, (us, c) in sorted(
                                kern.items(), key=lambda kv: -kv[1][0])[
                                    :TOP_KERNELS]],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, host_store_gb=store_gb,
               process_peak_rss_gb=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 1e6,
               evictions_total=after["embedding_evictions_total"] -
               before["embedding_evictions_total"],
               first_loss=losses[0], last_loss=losses[-1])
    emit(**rec)
    exe.close()
    del scope, table
    embedding.reset_tables()
    if not (rec["replays"] == timed and not rec["state_copies"] and
            rec["evictions_per_step"] > 0 and hits > 0 and
            all(math.isfinite(x) for x in losses)):
        raise AssertionError("host_embedding: full width: %s" % rec)
    return rec


def host_run(fluid, dev, main, loss, scope, feeds, graphs):
    exe = fluid.Executor(dev, cuda_graphs=graphs)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    exe.close()
    return losses


def host_vs_device(fluid, deepfm, embedding, monitor, dev):
    """Config 4 (vocabulary 100,000) at batch 1024 with fm_emb on a
    32,768-row cache against the device tier, from one state (the host
    store loaded with the device tier's initial fm_emb), over
    HOST_VS_DEVICE steps, graphed: losses within HOST_VS_DEVICE_RTOL
    relative, and after flush() the host store and its moments against
    the device table and moments within HOST_VS_DEVICE_RTOL of their
    largest magnitude, with evictions; whether each is equal to the bit
    is printed. The host tier graphed against eager, to the bit."""
    v = HOST_VS_DEVICE
    cfg = deepfm.DeepFMConfig()
    feeds = [deepfm.synthetic_batch(cfg, v["batch"], seed=200 + i)
             for i in range(v["steps"])]
    embedding.reset_tables()
    main, startup, loss, _ = deepfm_program(fluid, deepfm)
    dev_scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=dev_scope)
    start = clone_scope(fluid, dev_scope)
    init = start.find_var("fm_emb").cpu().numpy()
    dev_losses = host_run(fluid, dev, main, loss, dev_scope, feeds, True)
    runs = {}
    for mode, graphs in (("graphed", True), ("eager", False)):
        table, hmain, hstart, hloss = host_program(
            fluid, deepfm, embedding, cfg, v["budget"], init=init)
        sc = fluid.Scope()
        fluid.Executor(dev, cuda_graphs=False).run(hstart, scope=sc)
        # the shared state, and the cache's beta powers from fm_emb's (the
        # cache and its moments are admitted from the host store)
        for n in sc.local_var_names():
            src = start.find_var(n.replace("fm_emb@CACHE", "fm_emb"))
            if src is not None and src.shape == sc.find_var(n).shape:
                sc.set_var(n, src.clone())
        _, before = host_series(monitor)
        losses = host_run(fluid, dev, hmain, hloss, sc, feeds, graphs)
        _, after = host_series(monitor)
        state = {"fm_emb": table.snapshot(),
                 "fm_emb_moment1_0": table.slot_snapshot("adam:Moment1"),
                 "fm_emb_moment2_0": table.slot_snapshot("adam:Moment2")}
        state.update({n: sc.find_var(n).cpu().numpy()
                      for n in sc.local_var_names()
                      if not n.startswith("fm_emb@CACHE")})
        runs[mode] = (losses, state, series_delta(before, after))
        embedding.reset_tables()
    hl, hs, moved = runs["graphed"]
    el, es, _ = runs["eager"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(hl, dev_losses))
    gaps, equal = {}, {}
    for n, a in hs.items():
        want = dev_scope.find_var(n).cpu().numpy()
        gaps[n] = float(np.abs(a - want).max() / np.abs(want).max()) \
            if np.abs(want).max() else float(np.abs(a).max())
        equal[n] = bool(np.array_equal(a, want))
    eager_unequal = sorted(n for n in hs if not np.array_equal(hs[n], es[n]))
    rec = dict(phase="host_embedding", check="host_vs_device",
               vocab=cfg.sparse_feature_dim, **v,
               losses_host=hl, losses_device=dev_losses,
               loss_max_rel_gap=loss_gap,
               losses_equal_to_the_bit=hl == dev_losses,
               table_gaps={n: gaps[n] for n in (
                   "fm_emb", "fm_emb_moment1_0", "fm_emb_moment2_0")},
               state_max_rel_gap=max(gaps.values()),
               state_unequal=sorted(n for n, e in equal.items() if not e),
               evictions=moved["embedding_evictions_total"],
               host_graphed_vs_eager=dict(
                   losses_equal=hl == el, unequal=eager_unequal),
               rtol=HOST_VS_DEVICE_RTOL)
    emit(**rec)
    if not (loss_gap <= HOST_VS_DEVICE_RTOL and
            rec["state_max_rel_gap"] <= HOST_VS_DEVICE_RTOL and
            rec["evictions"] > 0 and hl == el and not eager_unequal):
        raise AssertionError("host_embedding: host vs device: %s" % rec)
    return rec


def write_multislot(path, deepfm, cfg, batches, batch, seed):
    """MultiSlot lines of config-4 samples: the fields as one slot of
    num_fields ids, the dense features, the label; ``batches`` seeded
    batches of ``batch`` (``deepfm.synthetic_batch``)."""
    with open(path, "w") as fh:
        for b in range(batches):
            f = deepfm.synthetic_batch(cfg, batch, seed=seed + b)
            ids = f["sparse_ids"].astype(str)
            dense = np.char.mod("%.6f", f["dense_x"])
            label = f["label"][:, 0].astype(str)
            head, mid = str(cfg.num_fields), str(cfg.num_dense)
            fh.write("\n".join(
                "%s %s %s %s 1 %s" % (head, " ".join(ids[i]), mid,
                                      " ".join(dense[i]), label[i])
                for i in range(batch)) + "\n")


def host_dataset(fluid, deepfm, embedding, monitor, dev):
    """HOST_DATASET["batches"] batches of config-4 samples written as
    MultiSlot files, loaded into an InMemoryDataset, one pass of the
    host-tier program by Executor.train_from_dataset; the same pass in a
    fresh scope by a plain exe.run loop over the same batches in order.
    The flushed host store and its moments, and every device persistable,
    equal to the bit; the pass's wall, examples/s and
    reader_prefetch_stall_seconds p50."""
    import tempfile

    d = HOST_DATASET
    cfg = host_cfg(deepfm, d["vocab"])
    stall = monitor.histogram("reader_prefetch_stall_seconds")
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for k in range(2):
            files.append(os.path.join(tmp, "part-%d" % k))
            write_multislot(files[-1], deepfm, cfg, d["batches"] // 2,
                            d["batch"],
                            seed=300 + k * d["batches"])
        t0 = time.perf_counter()
        out = {}
        for mode in ("train_from_dataset", "run_loop"):
            table, main, startup, loss = host_program(
                fluid, deepfm, embedding, cfg, d["budget"])
            block = main.global_block()
            if mode == "train_from_dataset":
                ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
                ds.set_batch_size(d["batch"])
                ds.set_use_var([block.var(n) for n in (
                    "sparse_ids", "dense_x", "label")])
                ds.set_filelist(files)
                ds.load_into_memory()
                load_s = time.perf_counter() - t0
            exe, scope = fluid.Executor(dev), fluid.Scope()
            fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
            if mode == "train_from_dataset":
                start = clone_scope(fluid, scope)
            else:
                for n in start.local_var_names():
                    scope.set_var(n, start.find_var(n).clone())
            _, before = host_series(monitor)
            stalls0 = stall.count
            sync(dev)
            t1 = time.perf_counter()
            if mode == "train_from_dataset":
                n_batches = exe.train_from_dataset(main, ds, scope=scope,
                                                   fetch_list=[loss])
            else:
                n_batches = 0
                for feed in ds.batch_reader()():
                    exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            return_numpy=False)
                    n_batches += 1
            sync(dev)
            wall = time.perf_counter() - t1
            _, after = host_series(monitor)
            state = {"host:values": table.snapshot()}
            state.update({"host:" + k: table.slot_snapshot(k) for k in (
                "adam:Moment1", "adam:Moment2")})
            state.update({n: scope.find_var(n).cpu().numpy()
                          for n in scope.local_var_names()})
            out[mode] = dict(state=state, wall_s=wall, batches=n_batches,
                             examples_per_s=n_batches * d["batch"] / wall,
                             stalls=stall.count - stalls0,
                             **series_delta(before, after))
            exe.close()
            embedding.reset_tables()
    tfd, loop = out["train_from_dataset"], out["run_loop"]
    unequal = sorted(n for n in tfd["state"]
                     if not np.array_equal(tfd["state"][n],
                                           loop["state"][n]))
    rec = dict(phase="host_embedding", check="train_from_dataset", **d,
               samples=ds.get_memory_data_size(), load_s=load_s,
               **{m: {k: v for k, v in r.items() if k != "state"}
                  for m, r in out.items()},
               reader_prefetch_stall_p50_ms=1e3 * (stall.quantile(0.5) or 0),
               states=len(tfd["state"]), unequal=unequal)
    emit(**rec)
    if unequal or tfd["batches"] != d["batches"] or \
            loop["batches"] != d["batches"] or \
            not tfd["embedding_evictions_total"]:
        raise AssertionError("host_embedding: train_from_dataset: %s" % rec)
    return rec


def host_embedding_path(A, dev):
    """The host embedding tier and dataset feeding on the card, with no
    CPU fallback: bench.py's embedding bench (``host_bench``), config 4's
    widths behind a device row cache at the Criteo Kaggle vocabulary
    (``host_full``), host tier against device tier (``host_vs_device``)
    and ``train_from_dataset`` against a plain loop
    (``host_dataset``). None of the 14 attention kernels runs: the host
    tier's lookup is a gather and its admissions and evictions row
    copies, which the reference computes with ``jnp.take`` and
    ``.at[].set`` outside any Pallas kernel."""
    from paddle_tpu_torch import embedding
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import monitor
    from paddle_tpu_torch.models import deepfm

    reset_launches(A)
    t0 = time.perf_counter()
    host_bench(fluid, deepfm, embedding, monitor, dev)
    torch.cuda.empty_cache()
    host_full(fluid, deepfm, embedding, monitor, dev)
    torch.cuda.empty_cache()
    host_vs_device(fluid, deepfm, embedding, monitor, dev)
    torch.cuda.empty_cache()
    host_dataset(fluid, deepfm, embedding, monitor, dev)
    torch.cuda.empty_cache()
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    emit(phase="host_embedding", check="attention_launches",
         launches=attention, phase_s=time.perf_counter() - t0)
    if any(attention.values()):
        raise AssertionError("host_embedding: an attention kernel ran: %s"
                             % attention)


# -- transformer_train: BASELINE config 5's training (bench.py:797) ---------
TFM_VOCAB = 32000
TFM_BATCH, TFM_SEQ = 32, 64        # bench.py's bench_transformer
TFM_EAGER_STEPS = 3
TFM_WARM, TFM_TIMED = 2, 10
# eager against traced: the same lowerings on the same card
TFM_TRACE_RTOL = 1e-6
# the card against the port's CPU path: full width, depth 2, batch 4.
# The losses are held to TFM_CPU_RTOL; every state, from step 1 on, by
# the L2 norm of card minus CPU over what the float64 run moved it
# (TFM_CPU_UPDATE_RTOL). Adam's first update is about lr * sign(g), so
# an element whose gradient is rounding noise (a key bias's, which
# softmax cancels, or one near eps) moves by +-lr on either side, and
# the largest difference over the largest magnitude of a bias that
# starts at 0 can reach 2 (0.354 at linear.b_3, H100 against the CPU).
TFM_CPU_LAYERS, TFM_CPU_BATCH = 2, 4
TFM_CPU_RTOL = 1e-5
TFM_CPU_UPDATE_RTOL = 0.1


def transformer_train_flops_per_step(batch, s, d, di, L, V):
    """The port's copy of ``bench.py:783-794``: the products of one
    Transformer train step, 3x the forward's (2 operations a
    multiply-add): per layer the q/k/v/out projections, the two attention
    products and the FFN, the decoder adding cross-attention, then the
    vocabulary head."""
    attn_proj = 4 * 2 * batch * s * d * d
    attn_mm = 4 * batch * s * s * d
    ffn = 2 * 2 * batch * s * d * di
    enc_layer = attn_proj + attn_mm + ffn
    dec_layer = 2 * (attn_proj + attn_mm) + ffn
    head = 2 * batch * s * d * V
    return 3 * (L * enc_layer + L * dec_layer + head)


def transformer_args(T, batch, seq, seed=0):
    """(src, tgt, pos, pos, causal bias) and the labels of one synthetic
    batch, numpy (``synthetic_batch``, ``make_causal_bias``)."""
    src, tgt, labels, pos = T.synthetic_batch(TFM_VOCAB, TFM_VOCAB, batch,
                                              seq, seed=seed)
    return (src, tgt, pos, pos, T.make_causal_bias(seq)), labels


def transformer_static(fluid, traced, seq, amp, vocab=TFM_VOCAB):
    """``bench.py:818-838`` on a TracedLayer: the loss (reshape to
    [-1, vocab], ``softmax_with_cross_entropy``, ``mean``) and
    Adam(1e-4), AMP-decorated when ``amp``, appended to the traced
    program. Returns (startup, loss)."""
    from paddle_tpu_torch.fluid import layers, optimizer
    from paddle_tpu_torch.fluid.contrib import mixed_precision

    startup = fluid.Program()
    with fluid.program_guard(traced.program, startup):
        logits = traced.program.global_block().var(traced._fetch_names[0])
        label = layers.data("tfm_label", [seq, 1], dtype="int64")
        flat = layers.reshape(logits, [-1, vocab])
        ce = layers.softmax_with_cross_entropy(
            flat, layers.reshape(label, [-1, 1]))
        loss = layers.mean(ce)
        opt = optimizer.Adam(learning_rate=1e-4)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return startup, loss


def transformer_feed(traced, args, labels, dev=None):
    feed = dict(zip(traced._feed_names, args))
    feed["tfm_label"] = labels
    if dev is not None:
        feed = {n: torch.from_numpy(v).to(dev) for n, v in feed.items()}
    return feed


def transformer_eager(T, fluid, dygraph, model, args, labels):
    """TFM_EAGER_STEPS eager dygraph steps of Adam(1e-4) on one batch
    through ``opt.minimize(loss, parameter_list=model.parameters())``:
    each step's wall ms (ending in the loss's fetch) and ops traced."""
    from paddle_tpu_torch.fluid import optimizer

    tracer = fluid.framework._dygraph_tracer()
    opt = optimizer.Adam(learning_rate=1e-4)
    feeds = [dygraph.to_variable(a) for a in args]
    lab = dygraph.to_variable(labels)
    losses, step_ms, ops = [], [], []
    for _ in range(TFM_EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n0 = tracer.traced_ops
        loss = T.loss_fn(model(*feeds), lab)
        model.clear_gradients()
        opt.minimize(loss, parameter_list=model.parameters())
        losses.append(float(loss.numpy()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        ops.append(tracer.traced_ops - n0)
    model.clear_gradients()
    rec = dict(phase="transformer_train", check="eager_dygraph",
               mode="dygraph.guard() + opt.minimize", steps=TFM_EAGER_STEPS,
               batch=TFM_BATCH, seq=TFM_SEQ, losses=losses,
               step_ms=step_ms, tokens_per_s=[
                   TFM_BATCH * TFM_SEQ / (ms / 1e3) for ms in step_ms],
               ops_traced_per_step=ops,
               parameters=len(model.parameters()))
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("transformer_train: eager losses not finite "
                             "and falling: %s" % losses)
    return rec


def transformer_eager_vs_traced(fluid, dygraph, model, args):
    """The model in eval() (dropout off): its eager fp32 output against
    ``jit.trace``'s program run by the executor, within TFM_TRACE_RTOL
    relative to the output's largest magnitude."""
    model.eval()
    with dygraph.no_grad():
        feeds = [dygraph.to_variable(a) for a in args]
        want = model(*feeds).numpy()
        _, traced = dygraph.jit.trace(model, feeds)
    got = traced(list(args))[0]
    traced._exe.close()
    model.train()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    rec = dict(phase="transformer_train", check="eager_vs_traced",
               shape=list(got.shape), max_rel=rel, rtol=TFM_TRACE_RTOL,
               traced_ops=len(traced.program.global_block().ops))
    emit(**rec)
    if not (np.isfinite(got).all() and rel <= TFM_TRACE_RTOL):
        raise AssertionError("transformer_train: traced vs eager: %s" % rec)


def transformer_timing(fluid, dev, main, feed, loss, scope):
    """Graphed steps on ``scope`` (the model's own tensors): TFM_WARM
    warm (run 1 eager, run 2 captured), TFM_TIMED timed, the fullest of
    TRACE_TRIES traced; TFM_TIMED eager-executor steps on a clone. Step
    ms (median), tokens/s, device busy and idle share, kernels and host
    launch calls a step, peak GB, MFU against BF16_PEAK_OPS_PER_S."""
    flops = transformer_train_flops_per_step(TFM_BATCH, TFM_SEQ, 1024, 4096,
                                             6, TFM_VOCAB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = dict(phase="transformer_train", check="step_times",
               config="Transformer.big (BASELINE config 5), jit.trace -> "
                      "AMP (bf16) Adam 1e-4, dropout 0.1",
               batch=TFM_BATCH, seq=TFM_SEQ, train_flops_per_step=flops)
    losses = []
    for mode, graphs, sc in (("graphed", True, scope),
                             ("eager_executor", False,
                              clone_scope(fluid, scope))):
        exe = fluid.Executor(dev, cuda_graphs=graphs)
        losses += fetch_losses(exe, main, feed, [loss], sc, TFM_WARM)
        step_s = []
        for _ in range(TFM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += fetch_losses(exe, main, feed, [loss], sc, 1)
            step_s.append(time.perf_counter() - t0)
        api, kern, totals, _ = complete_trace(
            lambda: fetch_losses(exe, main, feed, [loss], sc, 1))
        steady = statistics.median(step_s)
        busy_ms = sum(us for us, _ in kern.values()) / 1e3
        rec[mode] = dict(
            step_ms=steady * 1e3, step_ms_all=[t * 1e3 for t in step_s],
            tokens_per_s=TFM_BATCH * TFM_SEQ / steady,
            mfu=flops / steady / BF16_PEAK_OPS_PER_S,
            device_busy_ms=busy_ms if kern else "not measured",
            idle_share=1.0 - busy_ms / (steady * 1e3) if kern
            else "not measured",
            device_kernels_per_step=sum(n for _, n in kern.values()),
            kernels_per_trace=totals, host_launch_calls_per_step=api,
            attention_kernels_traced=traced_launches(kern),
            top_kernels=[dict(name=k[:120], ms=us / 1e3, calls=n)
                         for k, (us, n) in sorted(
                             kern.items(), key=lambda kv: -kv[1][0])[
                                 :TOP_KERNELS]])
        exe.close()
    rec.update(max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30, first_loss=losses[0], last_loss=losses[-1],
               steps=len(losses))
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("transformer_train: static losses not finite "
                             "and falling: %s" % losses)
    return rec


def transformer_card_vs_cpu(T, fluid, dygraph, dev):
    """Full width at depth TFM_CPU_LAYERS, batch TFM_CPU_BATCH, S
    TFM_SEQ, fp32, p 0: the traced program with Adam(1e-4), CHECK_STEPS
    steps (a fresh seeded batch each) from the card's startup state,
    graphed on the card against the port's CPU path and its float64 run
    (``card_vs_cpu``), under DeepFM's rules: every loss within
    max(TFM_CPU_RTOL, 3 x the fp32 noise), and every state by the L2 of
    what it moved, within max(TFM_CPU_UPDATE_RTOL, 3 x the CPU's own
    against float64), from step 1 on (TFM_CPU_UPDATE_RTOL's comment
    says why step 1 too)."""
    with fluid.unique_name.guard(), dygraph.guard(dev):
        model = T.Transformer(TFM_VOCAB, TFM_VOCAB, d_model=1024,
                              n_heads=16, d_inner=4096,
                              n_layers=TFM_CPU_LAYERS, dropout_rate=0.0,
                              seed=1)
        args, _ = transformer_args(T, TFM_CPU_BATCH, TFM_SEQ)
        with dygraph.no_grad():
            _, traced = dygraph.jit.trace(model, list(args))
    with fluid.unique_name.guard():
        startup, loss = transformer_static(fluid, traced, TFM_SEQ, amp=False)
    traced._materialize_scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=traced._scope)
    cpu = fluid.Scope()
    for n in traced._scope.local_var_names():
        cpu.set_var(n, traced._scope.find_var(n).cpu())
    feeds = []
    for i in range(CHECK_STEPS):
        a, lab = transformer_args(T, TFM_CPU_BATCH, TFM_SEQ, seed=11 + i)
        feeds.append(transformer_feed(traced, a, lab))
    bias = traced._feed_names[4]
    losses, rows = card_vs_cpu(
        fluid, dev, traced.program, loss, cpu, feeds,
        lambda f: dict(f, **{bias: f[bias].astype(np.float64)}))
    worst = sorted((r for r in rows if r[3] != "loss"),
                   key=lambda r: r[5] - r[4])
    rec = card_vs_cpu_record(
        losses, rows, TFM_CPU_RTOL, state_steps=0,
        update_rtol=TFM_CPU_UPDATE_RTOL, phase="transformer_train",
        layers=TFM_CPU_LAYERS, batch=TFM_CPU_BATCH, seq=TFM_SEQ,
        dtype="float32",
        update_rel_l2_by_step=[max(r[4] for r in rows if r[2] == step
                                   and r[3] != "loss" and r[4] > 3 * r[5])
                               if any(r[2] == step and r[3] != "loss"
                                      and r[4] > 3 * r[5] for r in rows)
                               else 0.0 for step in range(CHECK_STEPS)],
        largest_update_rel_l2_over_noise=[
            [r[2], r[3], r[4], r[5]] for r in worst[:10]])
    emit(**rec)
    del model, traced, cpu
    if rec["over"]:
        raise AssertionError("transformer_train: card vs CPU past max(%g, 3 "
                             "x fp32 noise): %s" % (TFM_CPU_RTOL, rec))


def transformer_train_path(A, dev):
    """BASELINE config 5's training as bench.py's bench_transformer runs
    it: ``Transformer.big(32000, 32000)`` (d 1024, 16 heads, d_inner
    4096, 6 + 6 layers) on the card under ``dygraph.guard()`` from a
    seeded generator, one synthetic batch of 32 x 64 tokens. Eager
    dygraph steps; the eager output against the traced program's; the
    program traced in training mode (dropout 0.1) with the loss and
    ``mixed_precision.decorate(Adam(1e-4))`` appended, graphed against
    eager to the bit from one state, then timed; the card against the
    CPU at depth 2. None of the 14 attention kernels runs: the
    reference's training forward computes attention as matmul, softmax,
    dropout and matmul, which lower to cuBLAS and ATen."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import dygraph
    from paddle_tpu_torch.models import transformer as T

    reset_launches(A)
    t0 = time.perf_counter()
    args, labels = transformer_args(T, TFM_BATCH, TFM_SEQ)
    with fluid.unique_name.guard(), dygraph.guard(dev):
        model = T.Transformer.big(TFM_VOCAB, TFM_VOCAB, seed=0)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        build_s = time.perf_counter() - t0
        eager_rec = transformer_eager(T, fluid, dygraph, model, args, labels)
        model.set_dict(start)
        transformer_eager_vs_traced(fluid, dygraph, model, args)
        model.set_dict(start)
        _, traced = dygraph.jit.trace(
            model, [dygraph.to_variable(a) for a in args])
    with fluid.unique_name.guard():
        startup, loss = transformer_static(fluid, traced, TFM_SEQ, amp=True)
    del start
    traced._materialize_scope()
    scope = traced._scope
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    bound = [n for n, p in model.named_parameters()
             if scope.find_var(p.name).data_ptr() != p.data_ptr()]
    feed = transformer_feed(traced, args, labels, dev)
    graphed_vs_eager(fluid, dev, traced.program, feed, loss, scope,
                     "transformer_train", amp="bfloat16", build_s=build_s,
                     program_ops=len(traced.program.global_block().ops))
    rec = transformer_timing(fluid, dev, traced.program, feed, loss, scope)
    moved = [n for n, p in model.named_parameters()
             if scope.find_var(p.name).data_ptr() != p.data_ptr()]
    del traced, scope, feed, model
    torch.cuda.empty_cache()
    transformer_card_vs_cpu(T, fluid, dygraph, dev)
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    traced_attention = {mode: rec[mode]["attention_kernels_traced"]
                        for mode in ("graphed", "eager_executor")}
    emit(phase="transformer_train", check="attention_launches",
         launches=attention, traced=traced_attention,
         scope_not_the_model_storage=bound + moved,
         phase_s=time.perf_counter() - t0)
    if any(attention.values()) or any(
            v for t in traced_attention.values() for v in t.values()):
        raise AssertionError("transformer_train: an attention kernel ran: "
                             "%s %s" % (attention, traced_attention))
    if bound or moved:
        raise AssertionError("transformer_train: the traced scope does not "
                             "hold the model's parameter storage: %s"
                             % (bound + moved))
    torch.cuda.empty_cache()
    return dict(rec, eager=eager_rec)


# The checkpoint phase: config 3 (BERT-base, batch 128, S 128, bf16 AMP,
# packed, dropout 0.1) built by build_pretrain_program as bert_packed
# builds it, fed by its py_reader (py_reader_batch=) over CKPT_BATCHES
# seeded numpy batches. Every run starts from clones of one startup
# state and generator, so every trajectory below is one trajectory and
# is held to the bit.
CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 12, 4, 2
CKPT_FAULT_AT, CKPT_DRAIN_AT = 6, 6
# iters=4 windows a run, prefetched and inline in turns
CKPT_WINDOW, CKPT_WINDOWS = 4, 4
CKPT_ROUNDS = (False, True, True, False)
CKPT_BATCHES = CKPT_WINDOW * CKPT_WINDOWS      # >= CKPT_STEPS + TRACE_TRIES
CKPT_CHILD_TIMEOUT_S = 300


def reader_program(fluid, bert, n_batches=CKPT_BATCHES):
    """(cfg, main, startup, loss) of config 3 fed by a py_reader
    (``main.py_reader``) over ``n_batches`` batches of seeds 100 on."""
    cfg = bert.BertConfig.base()
    cfg.use_fused_attention = "packed"
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=PACKED_SEQ, use_amp=True,
            py_reader_batch=PACKED_BATCH)
    batches = [bert.reader_batch(bert.synthetic_batch(
        cfg, PACKED_BATCH, PACKED_SEQ, seed=100 + i))
        for i in range(n_batches)]
    main.py_reader.decorate_tensor_provider(lambda: iter(batches))
    return cfg, main, startup, loss


def reader_steps(exe, main, loss, scope, n, **kw):
    """The losses of ``n`` single steps of a py_reader-fed ``main``."""
    return [float(np.asarray(exe.run(main, fetch_list=[loss], scope=scope,
                                     **kw)[0]).reshape(-1)[0])
            for _ in range(n)]


def state_digest(scope, names):
    """{name: sha256 of the tensor's bytes}: states of two processes
    compared to the bit."""
    import hashlib
    out = {}
    for n in names:
        t = scope.find_var(n).detach().contiguous().reshape(-1)
        out[n] = hashlib.sha256(memoryview(
            t.view(torch.uint8).cpu().numpy())).hexdigest()
    return out


def persistable_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def checkpoint_child(mode, dirname, dev=None):
    """A child process of the checkpoint phase (``python3 chip_smoke.py
    --checkpoint-child MODE DIR``), on the kernels the parent built.
    ``drain``: train the phase's run from its startup with
    ``checkpoint=(manager, CKPT_STEPS)``, a SIGTERM planted after step
    CKPT_DRAIN_AT (``worker.preempt``), one JSON line a step; the drain
    saves and exits 0 (returns 3 if it never came). ``resume``: restore
    with ``restore_on_restart`` and train to step CKPT_STEPS; print the
    losses and the final state's digest. ``dev``: the card unless a CPU
    rehearsal passes the CPU."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import faults
    from paddle_tpu_torch.fluid.io import CheckpointManager
    from paddle_tpu_torch.models import bert

    dev = torch.device("cuda") if dev is None else dev
    cfg, main, startup, loss = reader_program(fluid, bert)
    exe, scope = fluid.Executor(dev), fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    mgr = CheckpointManager(dirname, max_to_keep=CKPT_KEEP)
    if mode == "drain":
        faults.arm("worker.preempt", after_n=CKPT_DRAIN_AT - 1)
        main.py_reader.start()
        for step in range(1, CKPT_STEPS + 1):
            (out,) = exe.run(main, fetch_list=[loss], scope=scope,
                             checkpoint=(mgr, CKPT_STEPS))
            print(json.dumps({"step": step,
                              "loss": float(out.reshape(-1)[0])}),
                  flush=True)
            faults.check("worker.preempt")
        return 3
    start = mgr.restore_on_restart(exe, main, scope=scope)
    main.py_reader.start()
    losses = reader_steps(exe, main, loss, scope, CKPT_STEPS - start)
    print(json.dumps({"restored": start, "position": main.py_reader.position,
                      "losses": losses, "restore_s": mgr.last_restore_s,
                      "digest": state_digest(scope,
                                             persistable_names(main))}),
          flush=True)
    return 0


def prefetch_windows(fluid, monitor, dev, main, loss, init):
    """CKPT_ROUNDS runs of CKPT_WINDOWS iters=CKPT_WINDOW windows, with
    and without prefetch in turns, each from a clone of ``init``: the
    losses of each mode (two runs of a mode must agree), the window
    seconds after each run's first (which runs the eager step and the
    capture), and each run's prefetch series."""
    reader, runs = main.py_reader, {}
    stall = monitor.histogram("executor_window_stall_seconds")
    names = ("executor_window_overlap_hit_total",
             "executor_window_overlap_miss_total")
    for prefetch in CKPT_ROUNDS:
        sc, exe = clone_scope(fluid, init), fluid.Executor(dev)
        before = [monitor.counter(n).value for n in names]
        s0 = (stall.count, stall.sum)
        reader.start()
        losses, window_s = [], []
        for _ in range(CKPT_WINDOWS):
            sync(dev)
            t0 = time.perf_counter()
            (out,) = exe.run(main, fetch_list=[loss], scope=sc,
                             iters=CKPT_WINDOW, prefetch=prefetch)
            window_s.append(time.perf_counter() - t0)   # numpy fetch: synced
            losses.extend(np.asarray(out).reshape(CKPT_WINDOW, -1)[:, 0]
                          .tolist())
        exe.close()
        reader.reset()
        run = runs.setdefault(prefetch, dict(losses=losses, window_s=[],
                                             series=[]))
        if run["losses"] != losses:
            raise AssertionError("checkpoint: two runs with prefetch=%s "
                                 "differ: %s %s" % (prefetch, losses,
                                                    run["losses"]))
        run["window_s"].extend(window_s[1:])
        run["series"].append(dict(
            zip(("overlap_hit", "overlap_miss"),
                [monitor.counter(n).value - b
                 for n, b in zip(names, before)]),
            stall_count=stall.count - s0[0], stall_s=stall.sum - s0[1],
            inflight=monitor.gauge(
                "executor_window_prefetch_inflight").value))
        del sc, exe
        torch.cuda.empty_cache()
    return runs


def checkpoint_path(A, monitor, dev):
    """Config 3 fed by a py_reader (``reader_program``), from one
    startup state: prefetched iters=4 windows against inline ones in
    turns (equal to the bit; step ms, tokens/s, the prefetch series); 12
    uninterrupted steps (the reference trajectory and final state's
    digest; the attention kernels of a traced replay by name, 12 each);
    the same 12 steps with checkpoint=(CheckpointManager(max_to_keep=2,
    background=True), 4) and a non-finite step planted at step 6 under
    ``rollback``: the scope, the generator and the reader back at the
    step-4 version to the bit, no state tensor rebound (the next replay
    copies the restored values into the captured storage, counted), that
    replay's loss equal to a fresh eager run's from the version, the
    committed trajectory and final state equal to the uninterrupted
    ones; each save's snapshot, write and sha256 seconds and bytes, the
    restore's seconds; then a child process SIGTERM'd after step 6
    (drains: saves, marker, exit 0) and a second restoring with
    ``restore_on_restart``, its steps 7-12 and final state equal to the
    uninterrupted run's. Versions live in a temporary directory the
    phase removes."""
    import shutil
    import tempfile
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import faults
    from paddle_tpu_torch.fluid.io import CheckpointManager
    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    cfg, main, startup, loss = reader_program(fluid, bert)
    reader = main.py_reader
    names = persistable_names(main)
    init = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=init)

    # 1. prefetched windows against inline ones
    runs = prefetch_windows(fluid, monitor, dev, main, loss, init)
    step_ms = {("prefetch" if k else "inline"): statistics.median(
        v["window_s"]) * 1e3 / CKPT_WINDOW for k, v in runs.items()}
    rec = dict(phase="checkpoint", check="prefetch_vs_inline",
               config="BertConfig.base, packed", amp="bf16",
               batch=PACKED_BATCH, seq_len=PACKED_SEQ, iters=CKPT_WINDOW,
               windows=CKPT_WINDOWS, rounds=[int(p) for p in CKPT_ROUNDS],
               equal=runs[True]["losses"] == runs[False]["losses"],
               losses=runs[False]["losses"], step_ms=step_ms,
               tokens_per_s={k: PACKED_BATCH * PACKED_SEQ / v * 1e3
                             for k, v in step_ms.items()},
               window_s={("prefetch" if k else "inline"): v["window_s"]
                         for k, v in runs.items()},
               series={("prefetch" if k else "inline"): v["series"]
                       for k, v in runs.items()})
    emit(**rec)
    if not (rec["equal"] and all(math.isfinite(x) for x in rec["losses"])
            and all(s["overlap_hit"] == CKPT_WINDOWS - 1 and
                    s["overlap_miss"] == 1 and s["inflight"] == 0
                    for s in runs[True]["series"])):
        raise AssertionError("checkpoint: prefetched windows against "
                             "inline: %s" % rec)
    del runs

    # 2. the uninterrupted run, and a replay's kernels by name
    sc, exe = clone_scope(fluid, init), fluid.Executor(dev)
    reader.start()
    plain = reader_steps(exe, main, loss, sc, CKPT_STEPS)
    digest = state_digest(sc, names)
    _, kern, totals, diffs = complete_trace(
        lambda: reader_steps(exe, main, loss, sc, 1))
    replayed = traced_launches(kern)
    exe.close()
    reader.reset()
    del sc, exe
    emit(phase="checkpoint", check="uninterrupted", losses=plain,
         replay_launches=replayed, kernels_per_trace=totals,
         trace_diffs=diffs)
    if any(replayed[n] != cfg.n_layers for n in FUSED_KERNELS + TENSOR_CORES):
        raise AssertionError("checkpoint: a traced replay ran the attention "
                             "kernels %s times (want %d each)"
                             % (replayed, cfg.n_layers))

    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        rec = checkpointed_run(fluid, faults, monitor, dev, main, loss, init,
                               names, CheckpointManager,
                               os.path.join(tmp, "run"))
        rec.update(uninterrupted_equal=rec.pop("losses") == plain,
                   digest_equal=rec.pop("digest") == digest)
        emit(**rec)
        torch.cuda.empty_cache()
        if not (rec["rollback_exact"] and rec["uninterrupted_equal"] and
                rec["digest_equal"] and rec["eager_equal"] and
                rec["rebound"] == 0 and rec["new_captures"] == 0 and
                rec["state_copies"] == len(names) and
                rec["versions"] == [8, 12]):
            raise AssertionError("checkpoint: the checkpointed run with a "
                                 "rollback: %s" % rec)
        rec = drain_and_resume(CheckpointManager, tmp, plain, digest)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(**rec)
    if not (rec["drain_rc"] == 0 and rec["marker"] and
            rec["drained_at"] == CKPT_DRAIN_AT and rec["restored"] ==
            CKPT_DRAIN_AT and rec["resumed_equal"] and rec["digest_equal"]):
        raise AssertionError("checkpoint: drain and resume: %s" % rec)
    torch.cuda.empty_cache()


def checkpointed_run(fluid, faults, monitor, dev, main, loss, init, names,
                     manager_cls, dirname):
    """``checkpoint_path``'s run with versions every CKPT_EVERY steps and
    a rollback at step CKPT_FAULT_AT: the record of its checks, with the
    committed losses and the final digest under ``losses`` and
    ``digest``."""
    reader = main.py_reader
    mgr = manager_cls(dirname, max_to_keep=CKPT_KEEP, background=True)
    sc, exe = clone_scope(fluid, init), fluid.Executor(dev)
    ckpt = (mgr, CKPT_EVERY)
    reader.start()
    losses = reader_steps(exe, main, loss, sc, CKPT_EVERY, checkpoint=ckpt)
    version = {n: sc.find_var(n).clone() for n in names}
    rng = sc.generator.get_state()
    losses += reader_steps(exe, main, loss, sc,
                           CKPT_FAULT_AT - 1 - CKPT_EVERY, checkpoint=ckpt)
    storage = {n: sc.find_var(n).data_ptr() for n in names}
    counters = {n: monitor.counter(n).value for n in (
        "executor_graph_capture_total", "executor_graph_state_copy_total",
        "executor_anomaly_rollbacks_total")}
    fluid.set_flags({"FLAGS_anomaly_policy": "rollback"})
    faults.arm("step.nonfinite")
    try:
        reader_steps(exe, main, loss, sc, 1, checkpoint=ckpt)
    finally:
        faults.reset()
        fluid.set_flags({"FLAGS_anomaly_policy": "raise"})
    rolled = dict(
        state=all(torch.equal(sc.find_var(n), version[n]) for n in names),
        generator=torch.equal(sc.generator.get_state(), rng),
        position=reader.position, counter=mgr._step)
    # a fresh eager run from the version, on the batch after it
    fresh = fluid.Scope()
    eager = fluid.Executor(dev, cuda_graphs=False)
    manager_cls(dirname).restore(eager, main, scope=fresh)
    (eager_loss,) = reader_steps(eager, main, loss, fresh, 1)
    del fresh, eager
    reader.resume_at(CKPT_EVERY)
    (next_loss,) = reader_steps(exe, main, loss, sc, 1, checkpoint=ckpt)
    moved = {n: monitor.counter(n).value - v for n, v in counters.items()}
    rebound = sum(sc.find_var(n).data_ptr() != storage[n] for n in names)
    losses = losses[:CKPT_EVERY] + [next_loss] + reader_steps(
        exe, main, loss, sc, CKPT_STEPS - CKPT_EVERY - 1, checkpoint=ckpt)
    mgr.wait()
    digest = state_digest(sc, names)
    exe.close()
    reader.reset()
    del sc, exe, version
    return dict(
        phase="checkpoint", check="checkpoint_rollback", every=CKPT_EVERY,
        max_to_keep=CKPT_KEEP, fault_at=CKPT_FAULT_AT, rolled_back=rolled,
        rollback_exact=(rolled["state"] and rolled["generator"] and
                        rolled["position"] == CKPT_EVERY and
                        rolled["counter"] == CKPT_EVERY),
        eager_loss=eager_loss, next_replay_loss=next_loss,
        eager_equal=eager_loss == next_loss, rebound=rebound,
        new_captures=moved["executor_graph_capture_total"],
        state_copies=moved["executor_graph_state_copy_total"],
        rollbacks=moved["executor_anomaly_rollbacks_total"],
        saves=[dict(r) for r in mgr.history],
        restore_s=mgr.last_restore_s, versions=mgr.steps(),
        latest=mgr.latest(), losses=losses, digest=digest)


def drain_and_resume(manager_cls, tmp, plain, digest, cmd=None):
    """The two child processes of ``checkpoint_path``: one SIGTERM'd
    after step CKPT_DRAIN_AT, one resuming from its version. ``cmd``:
    the child's command line before its mode and directory (by default
    this script's ``--checkpoint-child``)."""
    dirname, hb = os.path.join(tmp, "child"), os.path.join(tmp, "hb")
    os.makedirs(hb)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, PADDLE_PREEMPT_DRAIN="1",
               PADDLE_HEARTBEAT_DIR=hb)
    cmd = cmd or [sys.executable, os.path.abspath(__file__),
                  "--checkpoint-child"]
    t0 = time.perf_counter()
    drain = subprocess.run(cmd + ["drain", dirname], env=env, cwd=here,
                           capture_output=True, text=True,
                           timeout=CKPT_CHILD_TIMEOUT_S)
    drain_s = time.perf_counter() - t0
    steps = [json.loads(line) for line in drain.stdout.splitlines()
             if line.startswith("{")]
    mgr = manager_cls(dirname)
    marker = os.path.join(hb, "hb.0.preempted")
    rec = dict(phase="checkpoint", check="drain_and_resume",
               drain_rc=drain.returncode, drain_s=drain_s,
               drain_steps=[s["step"] for s in steps],
               drain_losses_equal=[s["loss"] for s in steps] ==
               plain[:len(steps)], marker=os.path.exists(marker),
               drained_at=mgr.latest(), versions=mgr.steps(),
               drain_stderr=drain.stderr[-600:])
    if drain.returncode != 0:
        return rec
    t0 = time.perf_counter()
    resume = subprocess.run(cmd + ["resume", dirname],
                            env=dict(env, PADDLE_RESTART_ATTEMPT="1"),
                            cwd=here, capture_output=True, text=True,
                            timeout=CKPT_CHILD_TIMEOUT_S)
    got = [json.loads(line) for line in resume.stdout.splitlines()
           if line.startswith("{")]
    rec.update(resume_rc=resume.returncode,
               resume_s=time.perf_counter() - t0,
               resume_stderr=resume.stderr[-600:])
    if resume.returncode == 0 and got:
        got = got[-1]
        rec.update(restored=got["restored"], position=got["position"],
                   restore_s=got["restore_s"], losses=got["losses"],
                   resumed_equal=got["losses"] == plain[CKPT_DRAIN_AT:],
                   digest_equal=got["digest"] == digest)
    return rec


# The recompute phase: BERT-base with RecomputeOptimizer(Adam), each
# encoder layer's output a checkpoint, so every layer is recomputed in
# the backward (its attention forward launched again).
RC_STEPS = 4
RC_LONG_SEQ, RC_LONG_BATCH, RC_LONG_BIG = 8192, 2, 8
RC_LONG_TIMED = 2
# the share of the card a predicted peak may take
RC_MEMORY_SHARE = 0.85


def recompute_program(fluid, bert, seq, amp, recompute):
    cfg = bert.BertConfig.base()
    cfg.max_seq = max(cfg.max_seq, seq)
    with fluid.unique_name.guard():
        main, startup, loss = bert.build_pretrain_program(
            cfg, seq_len=seq, use_amp=amp, recompute=recompute)
    return cfg, main, startup, loss


def recompute_steps(A, fluid, dev, prog, scope, feed, n, trace=False):
    """``n`` graphed steps (an eager one, the capture, replays) of
    ``prog`` in ``scope``: (losses, step seconds, peak GB, the wrappers'
    launches (the eager step's), a traced replay's kernels or None)."""
    cfg, main, startup, loss = prog
    exe = fluid.Executor(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(A)
    losses, step_s = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = launches(A, FUSED_KERNELS)
    state = {n: scope.find_var(n).clone() for n in persistable_names(main)}
    replayed = traced_launches(complete_trace(lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))[1]) if trace \
        else None
    exe.close()
    return losses, step_s, peak, got, replayed, state


def recompute_path(A, dev):
    """BERT-base with RecomputeOptimizer(Adam) against Adam alone. At
    the bert shape (S 512, batch 32, fp32, dropout 0.1), from one state:
    4 graphed steps each way, losses and every persistable equal to the
    bit (the replayed draws); the attention forward launched 12 + 12 a
    step with recompute (the eager step's wrappers and a traced replay),
    dq and dk/dv 12; peak GB, step ms, tokens/s both ways. At S 8192 in
    AMP: batch 2 both ways, and batch 8 with recompute only (or the
    largest batch that fits by batch 2's peak): peak GB and step ms.
    Peaks must be lower with recompute."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    init, runs = None, {}
    for rc in (False, True):
        prog = recompute_program(fluid, bert, BERT_SEQ, False, rc)
        cfg, main, startup, _ = prog
        if init is None:
            init = fluid.Scope()
            fluid.Executor(dev, cuda_graphs=False).run(startup, scope=init)
        feed = bert.synthetic_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0)
        sc = clone_scope(fluid, init)
        runs[rc] = recompute_steps(A, fluid, dev, prog, sc, feed, RC_STEPS,
                                   trace=True)
        del sc
    del init
    (p_loss, p_s, p_peak, p_got, p_rep, p_state), \
        (r_loss, r_s, r_peak, r_got, r_rep, r_state) = runs[False], runs[True]
    equal = p_loss == r_loss and all(torch.equal(p_state[n], r_state[n])
                                     for n in p_state)
    steady = {"plain": statistics.median(p_s[2:]),
              "recompute": statistics.median(r_s[2:])}
    L = cfg.n_layers
    rec = dict(phase="recompute", config="BertConfig.base", batch=BERT_BATCH,
               seq_len=BERT_SEQ, dropout=cfg.hidden_dropout, steps=RC_STEPS,
               losses_plain=p_loss, losses_recompute=r_loss, equal=equal,
               launches={"plain": p_got, "recompute": r_got},
               replay_launches={"plain": p_rep, "recompute": r_rep},
               peak_gb={"plain": p_peak, "recompute": r_peak},
               step_ms={k: v * 1e3 for k, v in steady.items()},
               tokens_per_s={k: BERT_BATCH * BERT_SEQ / v
                             for k, v in steady.items()})
    emit(**rec)
    del runs, p_state, r_state
    want = {False: (L, L, L), True: (2 * L, L, L)}
    for rc, got, rep in ((False, p_got, p_rep), (True, r_got, r_rep)):
        for counts in (got, rep):
            if tuple(counts[n] for n in FUSED_KERNELS) != want[rc] or \
                    tuple(counts[n] for n in TENSOR_CORES) != want[rc]:
                raise AssertionError("recompute: attention launches %s "
                                     "(recompute=%s; want %s)"
                                     % (counts, rc, want[rc]))
    if not (equal and r_peak < p_peak and
            all(math.isfinite(x) for x in p_loss)):
        raise AssertionError("recompute: the bert shape: %s" % rec)

    # S 8192 in AMP
    torch.cuda.empty_cache()
    longs = {}
    for label, rc in (("plain", False), ("recompute", True)):
        longs[label] = recompute_long(A, fluid, bert, dev, rc, RC_LONG_BATCH)
    # the batch to run with recompute: RC_LONG_BIG if batch 2's peak says
    # it fits, else the largest that does (the state's bytes fixed, the
    # rest in proportion to the batch)
    card = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    fixed = longs["recompute"]["state_gb"]
    per_row = (longs["recompute"]["peak_gb"] - fixed) / RC_LONG_BATCH
    big = max(b for b in range(RC_LONG_BATCH, RC_LONG_BIG + 1)
              if fixed + per_row * b <= RC_MEMORY_SHARE * card)
    longs["recompute_big"] = recompute_long(A, fluid, bert, dev, True, big)
    rec = dict(phase="recompute", config="BertConfig.base, max_seq %d"
               % RC_LONG_SEQ, amp="bf16", seq_len=RC_LONG_SEQ, runs=longs,
               big_batch=big, big_batch_wanted=RC_LONG_BIG,
               big_batch_rule=dict(card_gb=card, state_gb=fixed,
                                   per_row_gb=per_row,
                                   share=RC_MEMORY_SHARE),
               phase_s=time.perf_counter() - t_phase)
    emit(**rec)
    if not (longs["recompute"]["peak_gb"] < longs["plain"]["peak_gb"] and
            all(math.isfinite(x) for r in longs.values()
                for x in r["losses"])):
        raise AssertionError("recompute: S %d: %s" % (RC_LONG_SEQ, rec))
    torch.cuda.empty_cache()


def recompute_long(A, fluid, bert, dev, rc, batch):
    """A warm step, the capture and RC_LONG_TIMED timed replays of
    BERT-base at RC_LONG_SEQ in AMP, with or without recompute, in a
    fresh scope: the record."""
    prog = recompute_program(fluid, bert, RC_LONG_SEQ, True, rc)
    cfg, main, startup, _ = prog
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    state_gb = sum(scope.find_var(n).numel() * scope.find_var(n)
                   .element_size() for n in persistable_names(main)) / 2 ** 30
    feed = bert.synthetic_batch(cfg, batch, RC_LONG_SEQ, seed=0)
    losses, step_s, peak, got, _, state = recompute_steps(
        A, fluid, dev, prog, scope, feed, 2 + RC_LONG_TIMED)
    del scope, state
    torch.cuda.empty_cache()
    steady = statistics.median(step_s[2:])
    return dict(batch=batch, recompute=rc, losses=losses, step_s=step_s,
                step_ms=steady * 1e3,
                tokens_per_s=batch * RC_LONG_SEQ / steady, peak_gb=peak,
                state_gb=state_gb, launches=got)



# -- seq2seq (book chapter 8) and the book's word2vec and VGG16-BN -------------
# The PaddlePaddle book's machine-translation widths (dictionaries of 30000
# on both sides, embedding and hidden 512, beam 4, batch 64), at a padded
# length of 50 on both sides: the reference model needs static lengths.
S2S = dict(src_vocab=30000, tgt_vocab=30000, emb_dim=512, hidden=512)
S2S_LEN, S2S_BATCH, S2S_BEAM = 50, 64, 4
S2S_WARM, S2S_TIMED, S2S_DECODE_TIMED = 2, 30, 5
S2S_CPU_BATCH = 8
# card vs CPU, one step: the loss (relative), and each persistable by the
# L2 of its difference over the L2 of what the float64 run moved it
S2S_CPU_RTOL, S2S_CPU_UPDATE_RTOL = 1e-4, 1e-2
# where the card's beams part from the CPU's, the two runs' selected
# scores at that step must agree within this (relative to a score, at
# least 1): a near-tie that fp32 rounding may order either way
S2S_NEAR_TIE = 1e-4
# kernels by name in a traced replay: the products, and the beam search's
# selection (torch.topk of the int64 keys) and backtracking (gathers)
PRODUCT_KERNEL = re.compile(r"gemm|xmma|cutlass|sgemm|gemv", re.I)
SELECT_KERNEL = re.compile(r"topk|sort|radix|bitonic|gatherTopK", re.I)
# word2vec (book chapter 4): the PTB dictionary at min_word_freq 50
W2V = dict(vocab=2073, embed=32, hidden=256, batch=100, steps=5)
W2V_TIMED = 50
# VGG16-BN on CIFAR-10 (book chapter 3)
VGG_BATCH, VGG_WARM, VGG_TIMED = 128, 2, 20


def card_scope_to_cpu(fluid, scope):
    cpu = fluid.Scope()
    for n in scope.local_var_names():
        cpu.set_var(n, scope.find_var(n).detach().cpu().clone())
    return cpu


def timed_replays(exe, main, feed, fetches, scope, warm, timed):
    """``warm`` runs (a key's eager run, then its capture), then ``timed``
    runs each to a synchronised fetch. Returns (the warm runs' seconds,
    the timed runs' seconds, every run's first fetch)."""
    warm_s, step_s, firsts = [], [], []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
        torch.cuda.synchronize()
        (warm_s if i < warm else step_s).append(time.perf_counter() - t0)
        firsts.append(np.asarray(out[0]))
    return warm_s, step_s, firsts


# A replay of a graph that draws random numbers launches two fills from
# the host besides the graph: the registered generator's seed and offset
REPLAY_HOST_KERNELS = 2


def replay_record(exe, run, step_ms, tries=TRACE_TRIES):
    """Busy ms, idle share, kernels and launch calls of the most complete
    of ``tries`` traced runs, which must be a replay (one graph launch,
    at most REPLAY_HOST_KERNELS kernels launched from the host), and its
    kernels grouped by name."""
    api, kern, _, _ = complete_trace(run, tries)
    if api and (api.get("cudaGraphLaunch") != 1 or
                api.get("cudaLaunchKernel", 0) > REPLAY_HOST_KERNELS):
        raise AssertionError("the traced run was not a graph replay: %s"
                             % api)
    busy = sum(us for us, _ in kern.values()) / 1e3
    return dict(device_busy_ms=busy if kern else "not measured",
                idle_share=1.0 - busy / step_ms if kern else "not measured",
                device_kernels_per_step=sum(n for _, n in kern.values()),
                host_launch_calls_per_step=api,
                top_kernels=[dict(name=k[:160], ms=us / 1e3, calls=n)
                             for k, (us, n) in sorted(
                                 kern.items(), key=lambda kv: -kv[1][0])
                             [:TOP_KERNELS]]), kern


def kernels_matching(kern, pattern):
    return {k[:160]: n for k, (_, n) in kern.items() if pattern.search(k)}


def kernels_ms(kern, pattern):
    return sum(us for k, (us, _) in kern.items() if pattern.search(k)) / 1e3


def s2s_feed(seq2seq, batch, seed, dev=None):
    """``synthetic_pairs`` at the phase's vocabulary and length."""
    feed = seq2seq.synthetic_pairs(np.random.RandomState(seed), batch,
                                   vocab=S2S["tgt_vocab"], src_len=S2S_LEN)
    if dev is None:
        return feed
    return {n: torch.from_numpy(a).to(dev) for n, a in feed.items()}


def beam_step_vars(main):
    """Each beam_search op's (selected_ids, parent_idx, selected_scores)
    vars, in step order."""
    return [(op.output("selected_ids")[0], op.output("parent_idx")[0],
             op.output("selected_scores")[0])
            for op in main.global_block().ops if op.type == "beam_search"]


def beam_parting(card, cpu, batch, beam):
    """Where the card's per-step selections part from the CPU's: for
    each batch row whose (ids, parents) differ at some step, the first
    such step and the largest difference of the two runs' sorted
    selected scores there (over a score's magnitude, at least 1)."""
    parts = []
    steps = len(card) // 3
    for b in range(batch):
        rows = slice(b * beam, (b + 1) * beam)
        for t in range(steps):
            ids_c, par_c, sc_c = (np.asarray(x).reshape(-1)[rows]
                                  for x in card[3 * t:3 * t + 3])
            ids_p, par_p, sc_p = (np.asarray(x).reshape(-1)[rows]
                                  for x in cpu[3 * t:3 * t + 3])
            if (ids_c != ids_p).any() or (par_c != par_p).any():
                a, c = np.sort(sc_c), np.sort(sc_p)
                gap = float(np.max(np.abs(a - c) /
                                   np.maximum(1.0, np.abs(c))))
                parts.append(dict(batch_row=b, step=t, score_gap=gap))
                break
    return parts


def seq2seq_path(A, inference, dev):
    """The book's GRU seq2seq at its widths (S2S, length S2S_LEN, batch
    S2S_BATCH): training graphed against eager, timed, and one step on the
    card against the CPU; then beam decode (beam S2S_BEAM, S2S_LEN steps)
    through the monolithic program, the split pair, a graphed replay and
    a served decode program, and at batch S2S_CPU_BATCH against the
    CPU."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import seq2seq

    reset_launches(A)
    widths = dict(S2S, src_len=S2S_LEN)
    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        main, startup, loss = seq2seq.build_train_program(
            tgt_len=S2S_LEN, **widths)
    build_s = time.perf_counter() - t0
    feed = s2s_feed(seq2seq, S2S_BATCH, 0, dev)
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, "seq2seq",
                     build_s=build_s, ops=len(main.global_block().ops))
    exe = fluid.Executor(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm_s, step_s, losses = timed_replays(exe, main, feed, [loss], scope,
                                           S2S_WARM, S2S_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_s)
    losses = [float(x.reshape(-1)[0]) for x in losses]
    rec, kern = replay_record(
        exe, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope), steady * 1e3)
    exe.close()
    tokens = S2S_BATCH * S2S_LEN
    rec = dict(phase="seq2seq", check="train_steps", mode="graphed",
               batch=S2S_BATCH, length=S2S_LEN, dtype="float32",
               optimizer="Adam", widths=S2S, build_s=build_s,
               program_ops=len(main.global_block().ops),
               first_run_s=warm_s[0], capture_run_s=warm_s[1],
               step_s=step_s, step_ms=steady * 1e3,
               target_tokens_per_s=tokens / steady,
               max_memory_allocated_gb=peak,
               attention_kernels_traced=traced_launches(kern),
               first_loss=losses[0], last_loss=losses[-1], **rec)
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("seq2seq: losses not finite and falling: %s"
                             % losses)
    seq2seq_card_vs_cpu(fluid, seq2seq, dev, main, startup, loss)
    seq2seq_decode(A, fluid, inference, seq2seq, dev, scope)
    del scope
    torch.cuda.empty_cache()
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    emit(phase="seq2seq", check="attention_launches", launches=attention,
         traced=rec["attention_kernels_traced"])
    if any(attention.values()) or any(
            rec["attention_kernels_traced"].values()):
        raise AssertionError("seq2seq: an attention kernel ran: %s"
                             % attention)


def seq2seq_card_vs_cpu(fluid, seq2seq, dev, main, startup, loss):
    """One step at batch S2S_CPU_BATCH, graphed on the card, from the
    CPU's startup state, against the port's CPU run of the same program
    and scope and its float64 run (``card_vs_cpu``): the loss within
    S2S_CPU_RTOL, every persistable by the L2 of its update within
    S2S_CPU_UPDATE_RTOL, each or 3x the CPU's own against float64."""
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    losses, rows = card_vs_cpu(fluid, dev, main, loss, cpu,
                               [s2s_feed(seq2seq, S2S_CPU_BATCH, 3)],
                               lambda f: f)
    rec = card_vs_cpu_record(losses, rows, S2S_CPU_RTOL, state_steps=0,
                             update_rtol=S2S_CPU_UPDATE_RTOL,
                             phase="seq2seq", batch=S2S_CPU_BATCH,
                             dtype="float32")
    emit(**rec)
    if rec["over"]:
        raise AssertionError("seq2seq: card vs CPU: %s" % rec)


def seq2seq_decode(A, fluid, inference, seq2seq, dev, scope):
    """Beam decode of batch S2S_BATCH from the trained ``scope``:
    monolithic (eager, captured, replayed: equal), the split pair (equal
    to it), the decode program served by a Predictor (equal); ms per
    decoded batch; a traced replay's products and beam-search kernels
    by name; at batch S2S_CPU_BATCH the card against the CPU."""
    import tempfile

    dec_kw = dict(tgt_vocab=S2S["tgt_vocab"], emb_dim=S2S["emb_dim"],
                  hidden=S2S["hidden"], max_tgt_len=S2S_LEN,
                  beam_size=S2S_BEAM)
    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        mono, _, seq = seq2seq.build_infer_program(
            src_vocab=S2S["src_vocab"], src_len=S2S_LEN, **dec_kw)
    with fluid.unique_name.guard():
        enc, _, enc_state = seq2seq.build_encoder_program(
            src_vocab=S2S["src_vocab"], emb_dim=S2S["emb_dim"],
            hidden=S2S["hidden"], src_len=S2S_LEN)
    with fluid.unique_name.guard():
        dec, _, dec_seq = seq2seq.build_decode_program(**dec_kw)
    build_s = time.perf_counter() - t0
    src = s2s_feed(seq2seq, S2S_BATCH, 11, dev)["s2s_src"]
    exe = fluid.Executor(dev)
    warm_s, mono_s, mono_out = timed_replays(
        exe, mono, {"s2s_src": src}, [seq], scope, S2S_WARM,
        S2S_DECODE_TIMED)
    replays_equal = all(np.array_equal(o, mono_out[0]) for o in mono_out)
    rec, kern = replay_record(
        exe, lambda: exe.run(mono, feed={"s2s_src": src}, fetch_list=[seq],
                             scope=scope), statistics.median(mono_s) * 1e3)
    split_s, split_out = [], []
    for _ in range(S2S_WARM + S2S_DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split_out.append(seq2seq.run_split_infer(exe, scope, enc, enc_state,
                                                 dec, dec_seq, src))
        torch.cuda.synchronize()
        split_s.append(time.perf_counter() - t0)
    split_s = split_s[S2S_WARM:]
    split_equal = all(np.array_equal(o, mono_out[0]) for o in split_out)
    state = exe.run(enc, feed={"s2s_src": src}, fetch_list=[enc_state],
                    scope=scope)[0]
    exe.close()
    with tempfile.TemporaryDirectory() as model_dir:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(
                model_dir, ["s2s_enc_state"], [dec_seq],
                fluid.Executor(dev, cuda_graphs=False), main_program=dec)
        pred = inference.create_predictor(inference.Config(model_dir,
                                                           place=dev))
        served = [pred.run({"s2s_enc_state": state})[0] for _ in range(3)]
    served_equal = all(np.array_equal(o, mono_out[0]) for o in served)
    products = kernels_matching(kern, PRODUCT_KERNEL)
    select = kernels_matching(kern, SELECT_KERNEL)
    mono_ms = statistics.median(mono_s) * 1e3
    split_ms = statistics.median(split_s) * 1e3
    rec = dict(phase="seq2seq", check="beam_decode", batch=S2S_BATCH,
               beam=S2S_BEAM, max_tgt_len=S2S_LEN, build_s=build_s,
               decode_program_ops=len(mono.global_block().ops),
               first_run_s=warm_s[0], capture_run_s=warm_s[1],
               monolithic_ms=mono_ms, split_ms=split_ms,
               split_saving_ms=mono_ms - split_ms,
               sequences_shape=list(mono_out[0].shape),
               distinct_tokens=int(len(np.unique(mono_out[0]))),
               eager_equals_replays=replays_equal,
               split_equals_monolithic=split_equal,
               predictor_equals_monolithic=served_equal,
               product_kernels=products,
               product_kernels_per_replay=sum(products.values()),
               product_ms=kernels_ms(kern, PRODUCT_KERNEL),
               beam_select_kernels=select,
               beam_select_kernels_per_replay=sum(select.values()),
               beam_select_ms=kernels_ms(kern, SELECT_KERNEL), **rec)
    emit(**rec)
    if not (replays_equal and split_equal and served_equal and products
            and select and mono_out[0].shape == (S2S_LEN,
                                                 S2S_BATCH * S2S_BEAM)):
        raise AssertionError("seq2seq decode: %s" % rec)
    seq2seq_decode_vs_cpu(fluid, dev, mono, seq, scope, src)


def seq2seq_decode_vs_cpu(fluid, dev, mono, seq, scope, src):
    """The decode of the first S2S_CPU_BATCH sources on the card (eager)
    and on the CPU from one scope: the sequences equal, or a batch row
    parts only at a step where the two runs' selected scores agree
    within S2S_NEAR_TIE (a near-tie)."""
    fetches = [seq] + [n for v in beam_step_vars(mono) for n in v]
    feed = {"s2s_src": src[:S2S_CPU_BATCH].cpu().numpy()}
    card = fluid.Executor(dev, cuda_graphs=False).run(
        mono, feed=feed, fetch_list=fetches, scope=scope)
    cpu = fluid.Executor("cpu").run(mono, feed=feed, fetch_list=fetches,
                                    scope=card_scope_to_cpu(fluid, scope))
    parts = beam_parting(card[1:], cpu[1:], S2S_CPU_BATCH, S2S_BEAM)
    beams_equal = (card[0] == cpu[0]).all(axis=0)
    rec = dict(phase="seq2seq", check="decode_card_vs_cpu",
               batch=S2S_CPU_BATCH, beam=S2S_BEAM,
               equal_beam_share=float(beams_equal.mean()),
               equal_batch_row_share=1.0 - len(parts) / S2S_CPU_BATCH,
               parted=parts, near_tie=S2S_NEAR_TIE)
    emit(**rec)
    if any(p["score_gap"] > S2S_NEAR_TIE for p in parts) or (
            not parts and not beams_equal.all()):
        raise AssertionError("seq2seq: the card's beams part from the "
                             "CPU's away from a near-tie: %s" % rec)


def word2vec_program(fluid, word2vec, clip):
    """The book's word2vec at W2V's widths, Adam on an
    ``exponential_decay(1e-3, 100, 0.9, staircase=True)`` learning rate
    with ``GradientClipByGlobalNorm(5.0)``. Returns (main, startup, loss,
    the learning-rate var)."""
    from paddle_tpu_torch.fluid import layers, optimizer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = [layers.data("w2v_ctx%d" % i, [1], dtype="int64")
                 for i in range(word2vec.N_CONTEXT)]
        nxt = layers.data("w2v_next", [1], dtype="int64")
        loss, _ = word2vec.word2vec_forward(words, nxt, W2V["vocab"],
                                            W2V["embed"], W2V["hidden"])
        lr = layers.exponential_decay(1e-3, 100, 0.9, staircase=True)
        optimizer.Adam(learning_rate=lr,
                       grad_clip=clip.GradientClipByGlobalNorm(5.0)
                       ).minimize(loss)
    return main, startup, loss, lr


def w2v_closed_form(step):
    return float(np.float32(0.9) ** np.float32(step // 100)
                 * np.float32(1e-3))


def word2vec_path(fluid, monitor, dev):
    """word2vec: graphed against eager over W2V["steps"] steps; the
    counter set to 96, then 7 runs (an eager one, the capture, 5
    replays), the learning rate read back after each equal to the closed
    form at the counter the run left (it crosses the staircase at 100);
    steps/s and the idle share of a replay."""
    from paddle_tpu_torch.fluid import clip
    from paddle_tpu_torch.models import word2vec

    main, startup, loss, lr = word2vec_program(fluid, word2vec, clip)
    feed = {n: torch.from_numpy(a).to(dev) for n, a in
            word2vec.synthetic_ngrams(np.random.RandomState(0), W2V["batch"],
                                      W2V["vocab"]).items()}
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, "book",
                     steps=W2V["steps"], model="word2vec")
    sc, exe = clone_scope(fluid, scope), fluid.Executor(dev)
    sc.set_var("@LR_STEP@", torch.full((1,), 96, dtype=torch.int64,
                                       device=dev))
    replays = monitor.counter("executor_graph_replay_total")
    r0 = replays.value
    read = []
    for _ in range(7):
        got = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=sc)
        step = int(sc.find_var("@LR_STEP@").item())
        read.append((step, float(np.asarray(got[1]).reshape(-1)[0]),
                     w2v_closed_form(step)))
    n_replays = replays.value - r0
    lr_ok = all(math.isclose(got, want, rel_tol=1e-6)
                for _, got, want in read)
    _, step_s, losses = timed_replays(exe, main, feed, [loss, lr], sc, 0,
                                      W2V_TIMED)
    steady = statistics.median(step_s)
    rec, _ = replay_record(
        exe, lambda: exe.run(main, feed=feed, fetch_list=[loss, lr],
                             scope=sc), steady * 1e3)
    exe.close()
    rec = dict(phase="book", check="word2vec", batch=W2V["batch"],
               widths=W2V, lr_schedule="exponential_decay(1e-3, 100, 0.9, "
               "staircase=True)", grad_clip="GradientClipByGlobalNorm(5.0)",
               lr_read_back=[list(r) for r in read], replays=n_replays,
               step_ms=steady * 1e3, steps_per_s=1.0 / steady,
               examples_per_s=W2V["batch"] / steady,
               losses=[float(x.reshape(-1)[0]) for x in losses[::10]], **rec)
    emit(**rec)
    steps = [r[0] for r in read]
    if not (lr_ok and steps == list(range(97, 104)) and n_replays >= 5 and
            read[-1][1] < read[0][1]):
        raise AssertionError("book: word2vec's learning rate did not "
                             "follow @LR_STEP@ across replays: %s" % rec)


def vgg_path(fluid, dev):
    """VGG16-BN at width 1.0, batch VGG_BATCH, its dropout at the built
    rates: graphed against eager over 3 steps; the convolution kernels
    of an eager step and of a replay (each the most complete of
    TRACE_TRIES traces) equal by name; timed replays: images/s, step ms,
    peak GB, idle share."""
    from paddle_tpu_torch.models import vgg

    with fluid.unique_name.guard():
        main, startup, loss, acc = vgg.build_train_program()
    g = torch.Generator(device=dev).manual_seed(0)
    feed = {"vgg_img": torch.rand(VGG_BATCH, 3, 32, 32, generator=g,
                                  device=dev),
            "vgg_label": torch.randint(0, 10, (VGG_BATCH, 1), generator=g,
                                       device=dev)}
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, "book",
                     model="vgg16_bn",
                     dropout=[op.attr("dropout_prob")
                              for op in main.global_block().ops
                              if op.type == "dropout"])
    # the eager step's kernels from the most complete of TRACE_TRIES
    # traces (a trace can lose a step's first kernels), on a clone
    eager, sc = fluid.Executor(dev, cuda_graphs=False), clone_scope(fluid,
                                                                   scope)
    _, eager_kern, _, _ = complete_trace(
        lambda: eager.run(main, feed=feed, fetch_list=[loss, acc],
                          scope=sc))
    del sc
    exe = fluid.Executor(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # a workspace the capture cannot allocate (an OOM the allocator
    # counts) makes cuDNN fall back to another algorithm
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    ooms = torch.cuda.memory_stats().get("num_ooms", 0)
    _, step_s, losses = timed_replays(exe, main, feed, [loss, acc], scope,
                                      VGG_WARM, VGG_TIMED)
    ooms = torch.cuda.memory_stats().get("num_ooms", 0) - ooms
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_s)
    rec, kern = replay_record(
        exe, lambda: exe.run(main, feed=feed, fetch_list=[loss, acc],
                             scope=scope), steady * 1e3)
    exe.close()
    eager_conv, replay_conv = conv_kernels(eager_kern), conv_kernels(kern)
    losses = [float(x.reshape(-1)[0]) for x in losses]
    flops = 3 * program_flops(main, VGG_BATCH)
    rec = dict(phase="book", check="vgg16_bn", batch=VGG_BATCH,
               width_mult=1.0, dtype="float32", optimizer="Adam",
               step_ms=steady * 1e3, images_per_s=VGG_BATCH / steady,
               max_memory_allocated_gb=peak, train_flops_per_step=flops,
               achieved_tflops=flops / steady / 1e12,
               conv_kernels={k: n for k, n in kernels_matching(
                   kern, CONV_KERNEL).items()},
               conv_replay_equals_eager=replay_conv == eager_conv,
               conv_replay_only=sorted(set(replay_conv) - set(eager_conv)),
               conv_eager_only=sorted(set(eager_conv) - set(replay_conv)),
               free_gib_before_capture=free_gib, capture_ooms=ooms,
               first_loss=losses[0], last_loss=losses[-1], **rec)
    emit(**rec)
    if not (eager_conv and replay_conv == eager_conv and
            all(math.isfinite(x) for x in losses)):
        raise AssertionError("book: vgg16_bn: %s" % rec)


def book_path(A, monitor, dev):
    """The book's word2vec and VGG16-BN (``word2vec_path``,
    ``vgg_path``); no attention kernel runs."""
    from paddle_tpu_torch import fluid

    reset_launches(A)
    word2vec_path(fluid, monitor, dev)
    torch.cuda.empty_cache()
    vgg_path(fluid, dev)
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    emit(phase="book", check="attention_launches", launches=attention)
    if any(attention.values()):
        raise AssertionError("book: an attention kernel ran: %s" % attention)


# -- sentiment (book chapter 6): LoD reviews through conv and LSTM nets --------
# The book's understand_sentiment widths (EMB_DIM 128, HID_DIM 512,
# STACKED_NUM 3, BATCH_SIZE 128, CLASS_DIM 2) over its IMDB word_dict()
# of 5147 words, on the reference model's Adam. Reviews are drawn from a
# seed: lengths uniform in SNT_LEN (about IMDB's mean of 230 words; longer
# reviews cut at 400), words from the half of the dictionary their label
# picks (models/sentiment.py's synthetic_reviews at these widths).
SNT = dict(vocab=5147, emb_dim=128, hid_dim=512, stacked_num=3,
           class_dim=2)
SNT_BATCH, SNT_LEN, SNT_LR = 128, (24, 400), 1e-3
SNT_WARM, SNT_TIMED = 2, 10
# the LSTM net's step unrolls 3 x 448 time steps (81k kernels a replay):
# its graphed-vs-eager check runs 2 steps (the second captured and
# replayed) and one trace of a replay, to keep the phase short
SNT_LSTM_CHECK_STEPS, SNT_LSTM_TRACES = 2, 1
SNT_CPU_BATCH = 8
SNT_CPU_RTOL, SNT_CPU_UPDATE_RTOL = 1e-4, 1e-2
# one review past the cut: its batch's longest length falls in a larger
# time bound than the timed batches' (lod.length_bound)
SNT_LONG = 500
SNT_DATASET_LINES, SNT_DATASET_BATCH = 64, 32
# printed beside each net's time bound (fluid/lod.py, length_bound)
SNT_BOUND_RULE = ("the smallest of 16, 20, 24, 28, 32, 40, 48, 56, 64, "
                  "80, ... (four steps a doubling from 16) that holds the "
                  "longest sequence, at most the rows; the step is keyed "
                  "by it")


def snt_reviews(seed, batch, long=None):
    """(lengths, flat word ids, labels) of ``batch`` reviews drawn from
    ``seed``; ``long`` sets the first review's length."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, SNT["class_dim"], batch).astype(np.int64)
    lens = rng.randint(SNT_LEN[0], SNT_LEN[1] + 1, batch)
    if long is not None:
        lens[0] = long
    half = SNT["vocab"] // 2
    words = [rng.randint(half if y else 0, SNT["vocab"] if y else half, n)
             for y, n in zip(labels, lens)]
    return lens.tolist(), np.concatenate(words).astype(np.int64), labels


def snt_feed(fluid, seed, batch, long=None):
    """A feed of ``snt_reviews``: the words as a LoDTensor padded to the
    dataset's row bound (a power of two: 32768 rows at batch 128),
    the labels [batch, 1]. Returns (feed, real tokens, time bound)."""
    from paddle_tpu_torch.fluid import lod

    lens, words, labels = snt_reviews(seed, batch, long)
    rows = fluid.dataset.DatasetBase._lod_bound(words.shape[0])
    data = np.zeros((rows, 1), np.int64)
    data[:words.shape[0], 0] = words
    return ({"snt_words": fluid.create_lod_tensor(data, [lens]),
             "snt_label": labels[:, None]}, int(words.shape[0]),
            lod.length_bound(max(lens), rows))


def sentiment_program(fluid, sentiment, net):
    """The book's ``net`` ("conv" or "lstm") at SNT's widths, as
    models/sentiment.py builds it, on Adam(SNT_LR)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        data = fluid.layers.data("snt_words", [1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data("snt_label", [1], dtype="int64")
        widths = dict(class_dim=SNT["class_dim"], emb_dim=SNT["emb_dim"],
                      hid_dim=SNT["hid_dim"])
        if net == "conv":
            loss, acc, _ = sentiment.conv_net(data, label, SNT["vocab"],
                                              **widths)
        else:
            loss, acc, _ = sentiment.stacked_lstm_net(
                data, label, SNT["vocab"], stacked_num=SNT["stacked_num"],
                **widths)
        fluid.optimizer.Adam(learning_rate=SNT_LR).minimize(loss)
    return main, startup, loss, acc, data, label


def sentiment_net(fluid, monitor, sentiment, dev, net):
    """One net (``sentiment_path``); returns its program and scope."""
    marks = [("start", time.perf_counter())]
    lstm = net == "lstm"
    main, startup, loss, _, data, label = sentiment_program(
        fluid, sentiment, net)
    build_s = time.perf_counter() - marks[0][1]
    feed, tokens, bound = snt_feed(fluid, 0, SNT_BATCH)
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, "sentiment",
                     steps=SNT_LSTM_CHECK_STEPS if lstm else CHECK_STEPS,
                     net=net, time_bound=bound)
    marks.append(("graphed_vs_eager", time.perf_counter()))
    exe = fluid.Executor(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm_s, step_s, losses = timed_replays(exe, main, feed, [loss], scope,
                                           SNT_WARM, SNT_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_s)
    losses = [float(x.reshape(-1)[0]) for x in losses]
    marks.append(("timed", time.perf_counter()))
    rec, _ = replay_record(
        exe, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope), steady * 1e3,
        tries=SNT_LSTM_TRACES if lstm else TRACE_TRIES)
    marks.append(("trace", time.perf_counter()))

    def counts():
        return {n: monitor.counter(n).value for n in (
            "executor_graph_capture_total", "executor_graph_replay_total")}

    # another batch in the same buckets (rows and time bound) replays the
    # graph; the conv net: one whose longest review is in a larger time
    # bound captures anew (its first run eager, its second captured)
    before = counts()
    feed2, _, bound2 = snt_feed(fluid, 1, SNT_BATCH)
    exe.run(main, feed=feed2, fetch_list=[loss], scope=scope)
    same = counts()
    buckets = dict(
        rows=[f["snt_words"].shape[0] for f in (feed, feed2)],
        time_bounds=[bound, bound2],
        same_bucket_new_captures=same["executor_graph_capture_total"] -
        before["executor_graph_capture_total"],
        same_bucket_replays=same["executor_graph_replay_total"] -
        before["executor_graph_replay_total"])
    ok = (bound2 == bound and buckets["rows"][1] == buckets["rows"][0]
          and buckets["same_bucket_new_captures"] == 0
          and buckets["same_bucket_replays"] == 1)
    if not lstm:
        feed3, _, bound3 = snt_feed(fluid, 2, SNT_BATCH, long=SNT_LONG)
        for _ in range(2):
            exe.run(main, feed=feed3, fetch_list=[loss], scope=scope)
        larger = counts()
        buckets["rows"].append(feed3["snt_words"].shape[0])
        buckets["time_bounds"].append(bound3)
        buckets["larger_bucket_new_captures"] = \
            larger["executor_graph_capture_total"] - \
            same["executor_graph_capture_total"]
        ok = ok and bound3 > bound and \
            buckets["larger_bucket_new_captures"] == 1
    exe.close()
    marks.append(("buckets", time.perf_counter()))
    rec = dict(phase="sentiment", check="train_steps", net=net,
               mode="graphed", batch=SNT_BATCH, lengths=list(SNT_LEN),
               dtype="float32", optimizer="Adam", widths=SNT,
               real_tokens=tokens, time_bound=bound,
               time_bound_rule=SNT_BOUND_RULE, build_s=build_s,
               program_ops=len(main.global_block().ops),
               first_run_s=warm_s[0], capture_run_s=warm_s[1],
               step_s=step_s, step_ms=steady * 1e3,
               real_tokens_per_s=tokens / steady,
               max_memory_allocated_gb=peak, buckets=buckets,
               first_loss=losses[0], last_loss=losses[-1], **rec)
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("sentiment %s: losses not finite and falling: "
                             "%s" % (net, losses))
    if not ok:
        raise AssertionError("sentiment %s: buckets: %s" % (net, buckets))
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=cpu)
    losses, rows = card_vs_cpu(fluid, dev, main, loss, cpu,
                               [snt_feed(fluid, 5, SNT_CPU_BATCH)[0]],
                               lambda f: f)
    marks.append(("card_vs_cpu", time.perf_counter()))
    rec = card_vs_cpu_record(losses, rows, SNT_CPU_RTOL, state_steps=0,
                             update_rtol=SNT_CPU_UPDATE_RTOL,
                             phase="sentiment", net=net,
                             batch=SNT_CPU_BATCH, dtype="float32",
                             seconds={k: t - t0 for (k, t), (_, t0) in
                                      zip(marks[1:], marks)})
    emit(**rec)
    if rec["over"]:
        raise AssertionError("sentiment %s: card vs CPU: %s" % (net, rec))
    return main, loss, data, label, scope


def sentiment_dataset(fluid, dev, main, loss, data, label, scope):
    """One ``train_from_dataset`` pass over a MultiSlot file of
    SNT_DATASET_LINES reviews: a ragged word slot and a label slot."""
    import tempfile

    lens, words, labels = snt_reviews(7, SNT_DATASET_LINES)
    lines, at = [], 0
    for n, y in zip(lens, labels):
        lines.append(" ".join([str(n)] + [str(w) for w in words[at:at + n]]
                              + ["1", str(int(y))]))
        at += n
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reviews.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(SNT_DATASET_BATCH)
        ds.set_use_var([data, label])
        ds.set_filelist([path])
        ds.load_into_memory()
        exe = fluid.Executor(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = exe.train_from_dataset(main, ds, scope=scope,
                                         fetch_list=[loss])
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        exe.close()
    finite = all(bool(torch.isfinite(scope.find_var(n)).all())
                 for n in scope.local_var_names()
                 if scope.find_var(n).is_floating_point())
    rec = dict(phase="sentiment", check="train_from_dataset", net="conv",
               lines=SNT_DATASET_LINES, batch=SNT_DATASET_BATCH,
               batches=batches, pass_s=pass_s, state_finite=finite)
    emit(**rec)
    if batches != SNT_DATASET_LINES // SNT_DATASET_BATCH or not finite:
        raise AssertionError("sentiment: train_from_dataset: %s" % rec)


def sentiment_path(A, monitor, dev):
    """The book's sentiment nets on LoD reviews (module docstring): the
    convolution net, then the stacked-LSTM net, then one dataset pass;
    no attention kernel runs."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import sentiment

    t0 = time.perf_counter()
    reset_launches(A)
    main, loss, data, label, scope = sentiment_net(
        fluid, monitor, sentiment, dev, "conv")
    sentiment_dataset(fluid, dev, main, loss, data, label, scope)
    del scope
    torch.cuda.empty_cache()
    sentiment_net(fluid, monitor, sentiment, dev, "lstm")
    torch.cuda.empty_cache()
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    emit(phase="sentiment", check="attention_launches", launches=attention,
         phase_s=time.perf_counter() - t0)
    if any(attention.values()):
        raise AssertionError("sentiment: an attention kernel ran: %s"
                             % attention)


# -- tagger (book chapter 7): a GRU over LoD sentences and a CRF -------------
# The book's test_label_semantic_roles widths: the CoNLL-2005 word
# dictionary of 44068 words, embedding 32, hidden 512, BATCH_SIZE 10,
# Adam at 5e-3, and 59 tags (conll05.get_dict()'s label dictionary: B-
# and I- of each argument type, and O), through models/tagger.py's net
# (embedding, fc, dynamic_gru, emission fc, linear_chain_crf). Sentences
# drawn from a seed, lengths uniform in TAG_LEN (longer sentences cut at
# 60), tagged by the rule tag = word % num_tags (synthetic_tagging's).
TAG = dict(vocab=44068, num_tags=59, emb_dim=32, hidden=512)
TAG_BATCH, TAG_LEN, TAG_LR = 10, (5, 60), 5e-3
TAG_WARM, TAG_TIMED = 2, 10
TAG_CPU_BATCH = 4
TAG_CPU_RTOL, TAG_CPU_UPDATE_RTOL = 1e-4, 1e-2


def tagger_feed(fluid, seed, batch):
    """``batch`` sentences from ``seed`` as LoDTensors padded to the
    dataset's power-of-two row bound: (feed, real tokens, time bound)."""
    from paddle_tpu_torch.fluid import lod

    rng = np.random.RandomState(seed)
    lens = rng.randint(TAG_LEN[0], TAG_LEN[1] + 1, batch).tolist()
    tokens = sum(lens)
    rows = fluid.dataset.DatasetBase._lod_bound(tokens)
    words = np.zeros((rows, 1), np.int64)
    words[:tokens, 0] = rng.randint(0, TAG["vocab"], tokens)
    tags = words % TAG["num_tags"]
    tags[tokens:] = 0
    return ({"tg_words": fluid.create_lod_tensor(words, [lens]),
             "tg_tags": fluid.create_lod_tensor(tags, [lens])}, tokens,
            lod.length_bound(max(lens), rows))


def tagger_programs(fluid, tagger):
    """The training and decode programs at TAG's widths (one parameter
    set by name)."""
    widths = dict(vocab=TAG["vocab"], num_tags=TAG["num_tags"],
                  emb_dim=TAG["emb_dim"], hidden=TAG["hidden"])
    with fluid.unique_name.guard():
        main, startup, loss = tagger.build_train_program(lr=TAG_LR,
                                                         **widths)
    with fluid.unique_name.guard():
        decode, _, path = tagger.build_decode_program(**widths)
    return main, startup, loss, decode, path


def tagger_decode(fluid, dev, decode, path, scope, feed):
    """The Viterbi paths of ``feed``'s sentences from the trained
    ``scope``: eagerly, captured and replayed on the card, and on the
    CPU from the card's state. Every route must give the same tags."""
    words = {"tg_words": feed["tg_words"]}
    exe = fluid.Executor(dev)
    card = [np.asarray(exe.run(decode, feed=words, fetch_list=[path],
                               scope=scope)[0]) for _ in range(3)]
    exe.close()
    cpu = np.asarray(fluid.Executor("cpu").run(
        decode, feed=words, fetch_list=[path],
        scope=card_scope_to_cpu(fluid, scope))[0])
    lens = feed["tg_words"].recursive_sequence_lengths()[0]
    tokens = sum(lens)
    differ = np.flatnonzero(card[0][:tokens, 0] != cpu[:tokens, 0])
    rec = dict(phase="tagger", check="viterbi_card_vs_cpu",
               sentences=len(lens), tokens=tokens,
               routes_equal=all(np.array_equal(c, card[0]) for c in card),
               tokens_differing=int(differ.size),
               first_differing=int(differ[0]) if differ.size else None,
               tags_used=int(np.unique(cpu[:tokens]).size))
    emit(**rec)
    if not rec["routes_equal"] or differ.size:
        raise AssertionError("tagger: Viterbi paths: %s" % rec)


def trained_phase(fluid, dev, phase, main, startup, loss, feed,
                  cpu_feed, warm, timed, rtol, update_rtol, rates,
                  check_program=None, **where):
    """A training phase's checks on ``main``: graphed against eager to the
    bit, ``warm`` + ``timed`` replays (step ms, peak GB, capture s, a
    traced replay's kernels and idle share; the loss must fall), one
    step on ``cpu_feed`` on the card against the CPU and float64 from a
    fresh startup (the loss within ``rtol``, each persistable by the L2
    of its update within ``update_rtol``), of ``check_program`` (main,
    startup, loss) where given (``main`` at dropout 0), else of
    ``main``. ``rates`` maps a rate's name to what a step processes (its
    value a second); ``where`` joins the timed record. Returns the
    trained scope."""
    marks = [("start", time.perf_counter())]
    scope = fluid.Scope()
    fluid.Executor(dev, cuda_graphs=False).run(startup, scope=scope)
    graphed_vs_eager(fluid, dev, main, feed, loss, scope, phase)
    marks.append(("graphed_vs_eager", time.perf_counter()))
    exe = fluid.Executor(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm_s, step_s, losses = timed_replays(exe, main, feed, [loss], scope,
                                           warm, timed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_s)
    losses = [float(x.reshape(-1)[0]) for x in losses]
    rec, _ = replay_record(
        exe, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope), steady * 1e3)
    exe.close()
    marks.append(("timed", time.perf_counter()))
    rec = dict(phase=phase, check="train_steps", mode="graphed",
               dtype="float32", program_ops=len(main.global_block().ops),
               first_run_s=warm_s[0], capture_run_s=warm_s[1],
               step_s=step_s, step_ms=steady * 1e3,
               max_memory_allocated_gb=peak, first_loss=losses[0],
               last_loss=losses[-1], **where, **rec,
               **{k: n / steady for k, n in rates.items()})
    emit(**rec)
    if not (all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0]):
        raise AssertionError("%s: losses not finite and falling: %s"
                             % (phase, losses))
    cmain, cstartup, closs = check_program or (main, startup, loss)
    cpu = fluid.Scope()
    fluid.Executor("cpu").run(cstartup, scope=cpu)
    got, rows = card_vs_cpu(fluid, dev, cmain, closs, cpu, [cpu_feed],
                            lambda f: f)
    marks.append(("card_vs_cpu", time.perf_counter()))
    check = card_vs_cpu_record(got, rows, rtol, state_steps=0,
                               update_rtol=update_rtol, phase=phase,
                               dtype="float32",
                               seconds={k: t - t1 for (k, t), (_, t1) in
                                        zip(marks[1:], marks)})
    emit(**check)
    if check["over"]:
        raise AssertionError("%s: card vs CPU: %s" % (phase, check))
    return scope


def no_attention(A, phase, t0):
    """The phase launched no attention kernel; prints its seconds."""
    attention = launches(A, ["decode_attention_kernel",
                             "paged_attention_kernel", *FUSED_KERNELS])
    emit(phase=phase, check="attention_launches", launches=attention,
         phase_s=time.perf_counter() - t0)
    if any(attention.values()):
        raise AssertionError("%s: an attention kernel ran: %s"
                             % (phase, attention))


def tagger_path(A, dev):
    """The book's CRF tagger on LoD sentences (module docstring)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import tagger

    t0 = time.perf_counter()
    reset_launches(A)
    main, startup, loss, decode, path = tagger_programs(fluid, tagger)
    build_s = time.perf_counter() - t0
    feed, tokens, bound = tagger_feed(fluid, 0, TAG_BATCH)
    scope = trained_phase(
        fluid, dev, "tagger", main, startup, loss, feed,
        tagger_feed(fluid, 5, TAG_CPU_BATCH)[0], TAG_WARM, TAG_TIMED,
        TAG_CPU_RTOL, TAG_CPU_UPDATE_RTOL,
        {"real_tokens_per_s": tokens}, batch=TAG_BATCH,
        lengths=list(TAG_LEN), optimizer="Adam", widths=TAG,
        real_tokens=tokens, rows=feed["tg_words"].shape[0],
        time_bound=bound, time_bound_rule=SNT_BOUND_RULE, build_s=build_s,
        cpu_batch=TAG_CPU_BATCH)
    tagger_decode(fluid, dev, decode, path, scope, feed)
    del scope
    torch.cuda.empty_cache()
    no_attention(A, "tagger", t0)


# -- recommender (book chapter 5): MovieLens towers scored by cos_sim --------
# models/recommender.py's MovieLens-1M vocabularies and widths (32-wide
# embeddings, 200-wide towers), the book's batch of 256 on SGD at 0.2;
# 1-6 categories and 1-15 title words a film (synthetic_batch's draws).
REC_BATCH, REC_CATS, REC_TITLE, REC_LR = 256, (1, 6), (1, 15), 0.2
REC_WARM, REC_TIMED = 2, 20
REC_CPU_BATCH = 32
REC_CPU_RTOL, REC_CPU_UPDATE_RTOL = 1e-4, 1e-2


def rec_feed(fluid, recommender, seed, batch):
    """``synthetic_batch`` at REC's lengths, its ragged fields padded to
    the dataset's power-of-two row bound: (feed, {field: real ids})."""
    feed = recommender.synthetic_batch(
        batch, np.random.RandomState(seed), title_maxlen=REC_TITLE[1],
        cat_maxlen=REC_CATS[1])
    counts = {}
    for name in ("category_id", "movie_title"):
        t = feed[name]
        n = t.data().shape[0]
        data = np.zeros((fluid.dataset.DatasetBase._lod_bound(n), 1),
                        np.int64)
        data[:n] = t.data()
        feed[name] = fluid.create_lod_tensor(
            data, t.recursive_sequence_lengths())
        counts[name] = n
    return feed, counts


def recommender_path(A, dev):
    """The book's recommender (module docstring)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import recommender

    t0 = time.perf_counter()
    reset_launches(A)
    with fluid.unique_name.guard():
        main, startup, loss, _ = recommender.build_train_program(lr=REC_LR)
    feed, counts = rec_feed(fluid, recommender, 0, REC_BATCH)
    scope = trained_phase(
        fluid, dev, "recommender", main, startup, loss, feed,
        rec_feed(fluid, recommender, 5, REC_CPU_BATCH)[0], REC_WARM,
        REC_TIMED, REC_CPU_RTOL, REC_CPU_UPDATE_RTOL,
        {"examples_per_s": REC_BATCH}, batch=REC_BATCH,
        categories=list(REC_CATS), title_words=list(REC_TITLE), ids=counts,
        optimizer="SGD", cpu_batch=REC_CPU_BATCH)
    del scope
    torch.cuda.empty_cache()
    no_attention(A, "recommender", t0)


# -- control flow: the PTB language model ------------------------------------
# PaddlePaddle/models PaddleNLP/language_model/lm_model.py, "large"
# (Zaremba et al. 2014): 10000 words, 2 LSTM layers of 1500, 35 steps,
# batch 20, init_scale 0.04, dropout 0.65 (upscale_in_train), SGD at 1.0
# (the rate decays only from epoch 14) under GradientClipByGlobalNorm(10).
# Its two layers are written as matmul / split / sigmoid / tanh inside one
# StaticRNN, as lm_model.py's padding_rnn does. Token ids from a seed.
PTB = dict(vocab=10000, layers=2, hidden=1500, steps=35, batch=20,
           init_scale=0.04, dropout=0.65)
PTB_LR, PTB_CLIP = 1.0, 10.0
PTB_WARM, PTB_TIMED = 2, 10
PTB_DECODE = 50                    # greedy tokens a decode, batch PTB's
PTB_LOGITS_ATOL = 1e-4             # the decode's first logits, card vs CPU
PTB_CPU_RTOL, PTB_CPU_UPDATE_RTOL = 1e-4, 1e-2
CF_ATOL = 1e-6                     # the small control-flow programs


def ptb_lm_program(fluid, vocab, layers, hidden, steps, batch, init_scale,
                   dropout, lr=PTB_LR, clip=PTB_CLIP):
    """lm_model.py's LM (``rnn_model="static"`` as a StaticRNN): the
    embedding, ``layers`` LSTM layers over ``steps`` time steps, the
    softmax projection, the loss summed over time and averaged over the
    batch, SGD at ``lr`` under a global-norm clip. Build it inside
    ``fluid.unique_name.guard()``. Returns (main, startup, loss,
    last_hidden, last_cell): feed the last two back as the next batch's
    ``init_hidden`` / ``init_cell``."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", shape=[batch, steps, 1], dtype="int64",
                   append_batch_size=False)
        y = L.data("y", shape=[batch * steps, 1], dtype="int64",
                   append_batch_size=False)
        init_hidden = L.data("init_hidden", shape=[layers, batch, hidden],
                             dtype="float32", append_batch_size=False)
        init_cell = L.data("init_cell", shape=[layers, batch, hidden],
                           dtype="float32", append_batch_size=False)
        init_h = L.reshape(init_hidden, shape=[layers, -1, hidden])
        init_c = L.reshape(init_cell, shape=[layers, -1, hidden])
        uniform = fluid.initializer.UniformInitializer(low=-init_scale,
                                                       high=init_scale)
        emb = L.embedding(input=x, size=[vocab, hidden], dtype="float32",
                          is_sparse=False, param_attr=fluid.ParamAttr(
                              name="embedding_para", initializer=uniform))
        emb = L.reshape(emb, shape=[-1, steps, hidden])
        if dropout:
            emb = L.dropout(emb, dropout_prob=dropout,
                            dropout_implementation="upscale_in_train")
        weights, biases = ptb_cells(fluid, layers, hidden, init_scale)
        hs = ptb_states(L, init_h, layers, hidden)
        cs = ptb_states(L, init_c, layers, hidden)
        seq = L.transpose(emb, perm=[1, 0, 2])
        rnn = L.StaticRNN()
        with rnn.step():
            inp = rnn.step_input(seq)
            for k in range(layers):
                pre_h = rnn.memory(init=hs[k])
                pre_c = rnn.memory(init=cs[k])
                m, c = ptb_lstm(L, inp, pre_h, pre_c, weights[k], biases[k])
                rnn.update_memory(pre_h, m)
                rnn.update_memory(pre_c, c)
                rnn.step_output(m)
                rnn.step_output(c)
                inp = m
                if dropout:
                    inp = L.dropout(
                        inp, dropout_prob=dropout,
                        dropout_implementation="upscale_in_train")
            rnn.step_output(inp)
        outs = rnn()
        last_h, last_c = [], []
        for k in range(layers):
            m, c = outs[2 * k], outs[2 * k + 1]
            m.stop_gradient = True
            c.stop_gradient = True
            last_h.append(L.slice(m, axes=[0], starts=[steps - 1],
                                  ends=[steps]))
            last_c.append(L.slice(c, axes=[0], starts=[steps - 1],
                                  ends=[steps]))
        last_hidden = L.concat(last_h, 0)
        last_cell = L.concat(last_c, 0)
        out = L.reshape(L.transpose(outs[-1], perm=[1, 0, 2]),
                        shape=[-1, steps, hidden])
        logits = L.reshape(ptb_projection(fluid, out, vocab, hidden,
                                          init_scale), shape=[-1, vocab])
        loss = L.softmax_with_cross_entropy(logits=logits, label=y,
                                            soft_label=False)
        loss = L.reduce_sum(L.reduce_mean(L.reshape(loss, shape=[-1, steps]),
                                          dim=[0]))
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=clip))
        try:
            fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        finally:
            fluid.clip.set_gradient_clip(None)
    return main, startup, loss, last_hidden, last_cell


def ptb_cells(fluid, layers, hidden, init_scale):
    """Each layer's [2H, 4H] gate weight and [4H] bias (lm_model.py's
    names)."""
    L = fluid.layers
    uniform = fluid.initializer.UniformInitializer(low=-init_scale,
                                                   high=init_scale)
    weights = [L.create_parameter([hidden * 2, hidden * 4], "float32",
                                  name="fc_weight1_%d" % k,
                                  default_initializer=uniform)
               for k in range(layers)]
    biases = [L.create_parameter([hidden * 4], "float32",
                                 name="fc_bias1_%d" % k,
                                 default_initializer=fluid.initializer
                                 .Constant(0.0))
              for k in range(layers)]
    return weights, biases


def ptb_states(L, state, layers, hidden):
    """Each layer's [batch, hidden] slice of a [layers, batch, hidden]
    state."""
    return [L.reshape(L.slice(state, axes=[0], starts=[k], ends=[k + 1]),
                      shape=[-1, hidden]) for k in range(layers)]


def ptb_lstm(L, inp, pre_h, pre_c, weight, bias):
    """One LSTM step as lm_model.py writes it: (hidden, cell)."""
    gates = L.elementwise_add(L.matmul(L.concat([inp, pre_h], 1), weight),
                              bias)
    i, j, f, o = L.split(gates, num_or_sections=4, dim=-1)
    c = pre_c * L.sigmoid(f) + L.sigmoid(i) * L.tanh(j)
    return L.tanh(c) * L.sigmoid(o), c


def ptb_projection(fluid, out, vocab, hidden, init_scale):
    """``out`` times the softmax weight plus its bias: the logits."""
    L = fluid.layers
    uniform = fluid.initializer.UniformInitializer(low=-init_scale,
                                                   high=init_scale)
    w = L.create_parameter([hidden, vocab], "float32", name="softmax_weight",
                           default_initializer=uniform)
    b = L.create_parameter([vocab], "float32", name="softmax_bias",
                           default_initializer=uniform)
    return L.elementwise_add(L.matmul(out, w), b)


def ptb_feed(vocab, layers, hidden, steps, batch, seed, **_):
    """A batch of token ids from ``seed`` (x and its next-token labels y)
    and zero initial states."""
    ids = np.random.RandomState(seed).randint(
        0, vocab, (batch, steps + 1)).astype(np.int64)
    zeros = np.zeros((layers, batch, hidden), np.float32)
    return {"x": ids[:, :-1, None], "y": ids[:, 1:].reshape(-1, 1),
            "init_hidden": zeros, "init_cell": zeros.copy()}


def ptb_decode_program(fluid, vocab, layers, hidden, batch, n, bounded,
                       init_scale=0.04, **_):
    """Greedy decoding of ``n`` tokens from the LM's parameters (by
    name): token slot i of a bounded tensor array is read, embedded, run
    through the layers and projected; its top-1 is written to slot i +
    1. ``bounded=False``: a ``layers.While`` whose condition is read on
    the host each trip (the executor runs it eagerly); True: a
    ``while_loop(maximum_trip_count=n)``, which a CUDA graph captures.
    Feeds: ``first`` [batch, 1] int64 and the LM's ``init_hidden`` /
    ``init_cell``. Returns (main, tokens [batch, n + 1], the first
    step's logits or None)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        first = L.data("first", shape=[batch, 1], dtype="int64",
                       append_batch_size=False)
        init_hidden = L.data("init_hidden", shape=[layers, batch, hidden],
                             dtype="float32", append_batch_size=False)
        init_cell = L.data("init_cell", shape=[layers, batch, hidden],
                           dtype="float32", append_batch_size=False)
        weights, biases = ptb_cells(fluid, layers, hidden, init_scale)
        hs = ptb_states(L, init_hidden, layers, hidden)
        cs = ptb_states(L, init_cell, layers, hidden)
        tokens = L.create_array("int64", element_shape=[batch, 1],
                                bound=n + 1)
        L.array_write(first, 0, tokens)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", n)

        def step(i, hs, cs):
            inp = L.reshape(L.embedding(
                input=L.array_read(tokens, i), size=[vocab, hidden],
                dtype="float32", param_attr=fluid.ParamAttr(
                    name="embedding_para")), shape=[-1, hidden])
            new_h, new_c = [], []
            for k in range(layers):
                inp, c = ptb_lstm(L, inp, hs[k], cs[k], weights[k],
                                  biases[k])
                new_h.append(inp)
                new_c.append(c)
            logits = ptb_projection(fluid, inp, vocab, hidden, init_scale)
            _, top = L.topk(logits, k=1)
            return logits, top, new_h, new_c

        if bounded:
            def body(i, tokens, *state):
                _, top, new_h, new_c = step(i, state[:layers],
                                            state[layers:])
                nxt = L.increment(i, value=1, in_place=False)
                L.array_write(top, nxt, tokens)
                return [nxt, tokens] + new_h + new_c

            out = L.while_loop(lambda i, *rest: L.less_than(i, limit), body,
                               [i, tokens] + hs + cs,
                               maximum_trip_count=n)
            first_logits = None
            tokens = out[1]
        else:
            logits_arr = L.create_array("float32",
                                        element_shape=[batch, vocab],
                                        bound=n)
            cond = L.less_than(i, limit)
            loop = L.While(cond)
            with loop.block():
                logits, top, new_h, new_c = step(i, hs, cs)
                L.array_write(logits, i, logits_arr)
                L.increment(i, value=1)
                L.array_write(top, i, tokens)
                for k in range(layers):
                    L.assign(new_h[k], hs[k])
                    L.assign(new_c[k], cs[k])
                L.less_than(i, limit, cond=cond)
            first_logits = L.array_read(logits_arr, 0)
        seqs, _ = L.tensor_array_to_tensor(tokens, axis=1)
    return main, seqs, first_logits


def ptb_train_programs(fluid, dropout):
    with fluid.unique_name.guard():
        return ptb_lm_program(fluid, **dict(PTB, dropout=dropout))


def ptb_decodes(fluid, monitor, dev, scope):
    """Greedy decoding of PTB_DECODE tokens at PTB's batch from the
    trained ``scope``: through ``layers.While`` (eager by the executor's
    control_flow rule, 3 runs) and through ``while_loop(
    maximum_trip_count=)`` (run 1 eager, run 2 captured, then replays).
    Every run gives the same tokens; the While decode's first logits
    (a fourth run) agree with the CPU's on the card's state within
    PTB_LOGITS_ATOL."""
    progs = {}
    for bounded in (False, True):
        with fluid.unique_name.guard():
            progs[bounded] = ptb_decode_program(
                fluid, n=PTB_DECODE, bounded=bounded, **PTB)
    with fluid.unique_name.guard():
        one = ptb_decode_program(fluid, n=1, bounded=False, **PTB)
    B, layers, H = PTB["batch"], PTB["layers"], PTB["hidden"]
    zeros = np.zeros((layers, B, H), np.float32)
    feed = {"first": np.random.RandomState(7).randint(
        0, PTB["vocab"], (B, 1)).astype(np.int64),
        "init_hidden": zeros, "init_cell": zeros}
    rule = monitor.counter("executor_eager_by_rule_total",
                           labels={"rule": "control_flow"})
    captures = monitor.counter("executor_graph_capture_total")
    exe = fluid.Executor(dev)
    rule0, cap0 = rule.value, captures.value
    while_warm, while_s, while_out = timed_replays(
        exe, progs[False][0], feed, [progs[False][1]], scope, 1, 2)
    rule1, cap1 = rule.value, captures.value
    loop_warm, loop_s, loop_out = timed_replays(
        exe, progs[True][0], feed, [progs[True][1]], scope, 2, PTB_WARM + 1)
    cap2 = captures.value
    logits = exe.run(progs[False][0], feed=feed, fetch_list=[progs[False][2]],
                     scope=scope)[0]
    exe.close()
    cpu_logits = fluid.Executor("cpu").run(
        one[0], feed=feed, fetch_list=[one[2]],
        scope=card_scope_to_cpu(fluid, scope))[0]
    tokens = while_out[0]
    logit_err = float(np.abs(logits - cpu_logits).max())
    rec = dict(
        phase="control_flow", check="ptb_decode", batch=B,
        new_tokens=PTB_DECODE, tokens_shape=list(tokens.shape),
        while_ms=[x * 1e3 for x in while_warm + while_s],
        while_loop_bounded_ms=[x * 1e3 for x in loop_warm + loop_s],
        while_steady_ms=statistics.median(while_s) * 1e3,
        while_loop_replay_ms=statistics.median(loop_s) * 1e3,
        eager_by_control_flow_rule=rule1 - rule0,
        while_captures=cap1 - cap0, while_loop_captures=cap2 - cap1,
        while_runs_equal=all(np.array_equal(o, tokens) for o in while_out),
        while_loop_equal_while=all(np.array_equal(o, tokens)
                                   for o in loop_out),
        first_logits_max_abs_err=logit_err,
        first_logits_atol=PTB_LOGITS_ATOL,
        distinct_tokens=int(np.unique(tokens[:, 1:]).size))
    emit(**rec)
    if not (rec["while_runs_equal"] and rec["while_loop_equal_while"]
            and rec["eager_by_control_flow_rule"] == 3
            and rec["while_captures"] == 0
            and rec["while_loop_captures"] == 1
            and tokens.shape == (B, PTB_DECODE + 1)
            and np.array_equal(tokens[:, :1], feed["first"])
            and logit_err <= PTB_LOGITS_ATOL):
        raise AssertionError("control_flow: the PTB decodes: %s" % rec)


def cf_programs(fluid):
    """Small programs of cond, switch_case, IfElse and DynamicRNN, each
    (main, fetch, feed)."""
    L = fluid.layers
    rng = np.random.RandomState(3)
    x = rng.randn(64, 32).astype(np.float32)
    lens = rng.randint(1, 17, 16).tolist()
    flat = rng.randn(sum(lens), 32).astype(np.float32)

    def cond():
        xv = L.data("x", shape=[64, 32], dtype="float32",
                    append_batch_size=False)
        return L.cond(L.reduce_sum(xv) < 1e9, lambda: L.tanh(xv) * 2.0,
                      lambda: L.sigmoid(xv)), {"x": x}

    def switch_case():
        xv = L.data("x", shape=[64, 32], dtype="float32",
                    append_batch_size=False)
        idx = L.data("idx", shape=[1], dtype="int64",
                     append_batch_size=False)
        return L.switch_case(idx, {0: lambda: L.scale(xv, scale=2.0),
                                   1: lambda: L.tanh(xv)},
                             default=lambda: xv - 1.0), {
            "x": x, "idx": np.array([1], np.int64)}

    def ifelse():
        xv = L.data("x", shape=[64, 32], dtype="float32",
                    append_batch_size=False)
        ie = L.IfElse(L.greater_than(
            L.reduce_sum(xv, dim=1, keep_dim=True),
            L.fill_constant([64, 1], "float32", 0.0)))
        with ie.true_block():
            ie.output(ie.input(xv) * 2.0)
        with ie.false_block():
            ie.output(L.tanh(ie.input(xv)))
        return ie()[0], {"x": x}

    def dynamic_rnn():
        xv = L.data("x", shape=[-1, 32], dtype="float32",
                    append_batch_size=False, lod_level=1)
        drnn = L.DynamicRNN(maxlen=16)
        with drnn.block():
            xt = drnn.step_input(xv)
            h = drnn.memory(shape=[32], value=0.0)
            nh = L.tanh(L.elementwise_add(h, xt))
            drnn.update_memory(h, nh)
            drnn.output(nh)
        return drnn(), {"x": fluid.create_lod_tensor(flat, [lens])}

    progs = {}
    for name, fn in (("cond", cond), ("switch_case", switch_case),
                     ("IfElse", ifelse), ("DynamicRNN", dynamic_rnn)):
        main = fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, fluid.Program()):
            out, feed = fn()
        progs[name] = (main, out, feed)
    return progs


def cf_card_vs_cpu(fluid, dev):
    """Each of ``cf_programs`` 3 times on the card (cond and switch_case
    eager by the control_flow rule, IfElse and DynamicRNN run 1 eager,
    then captured and replayed) against the CPU, within CF_ATOL."""
    rec = dict(phase="control_flow", check="cf_card_vs_cpu",
               atol=CF_ATOL)
    for name, (main, out, feed) in cf_programs(fluid).items():
        want = fluid.Executor("cpu").run(main, feed=feed, fetch_list=[out],
                                         scope=fluid.Scope())[0]
        exe = fluid.Executor(dev)
        scope = fluid.Scope()
        got = [exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
               for _ in range(3)]
        exe.close()
        rec[name] = max(float(np.abs(g - want).max()) for g in got)
    emit(**rec)
    if any(rec[n] > CF_ATOL for n in ("cond", "switch_case", "IfElse",
                                      "DynamicRNN")):
        raise AssertionError("control_flow: card vs CPU: %s" % rec)


def control_flow_path(A, dev):
    """The PTB LM trained through StaticRNN and decoded through While
    (module docstring)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import monitor

    t0 = time.perf_counter()
    reset_launches(A)
    main, startup, loss, _, _ = ptb_train_programs(fluid, PTB["dropout"])
    check = ptb_train_programs(fluid, 0.0)[:3]
    build_s = time.perf_counter() - t0
    feed = ptb_feed(seed=0, **PTB)
    tokens = PTB["batch"] * PTB["steps"]
    scope = trained_phase(
        fluid, dev, "control_flow", main, startup, loss, feed, feed,
        PTB_WARM, PTB_TIMED, PTB_CPU_RTOL, PTB_CPU_UPDATE_RTOL,
        {"tokens_per_s": tokens}, check_program=check, widths=PTB,
        optimizer="SGD", lr=PTB_LR, global_norm_clip=PTB_CLIP,
        tokens_a_step=tokens, build_s=build_s, cpu_dropout=0.0)
    ptb_decodes(fluid, monitor, dev, scope)
    del scope
    torch.cuda.empty_cache()
    cf_card_vs_cpu(fluid, dev)
    no_attention(A, "control_flow", t0)


def main():
    if sys.argv[1:2] == ["--cold-start-child"]:
        # a helper process of phase cold_start (its PLACE may be the CPU,
        # a rehearsal's)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return cold_start_child(*sys.argv[2:7])
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--checkpoint-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return checkpoint_child(*sys.argv[2:4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.fluid import monitor
    from paddle_tpu_torch.kernels import _build, attention as A
    from paddle_tpu_torch.models import transformer as T

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    PHASE_CLOCK[:] = [t0]
    libs = _build.build_all()
    emit(phase="card", nvidia_smi=card, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         libraries=sorted(libs),
         fused_attention_resources=kernel_resources(_build, A))

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    decode = decode_cases(A, dev, gen, flush,
                          resources=decode_resources(_build))
    dense_rec, paged_rec = decode["path_f32"], decode["paged_path"]
    verify_rec = decode["verify_f32"]
    fused_rec, fused_p0_rec = fused_cases(A, dev, gen, flush)
    long_rec, flash_rec = long_cases(A, dev, flush)
    res_rec, packed_rec = packed_cases(A, dev, flush)
    packed_equals_per_head(A, dev)
    del flush
    torch.cuda.empty_cache()

    dense_pred, dense_launches, feed = dense_path(T, A, inference, monitor,
                                                  dev)
    paged_launches = serving_path(T, A, inference, monitor, dev, dense_pred,
                                  feed)
    del dense_pred
    card_memory("serving_path")
    bert_launches = bert_path(A, dev)
    card_memory("bert_path")
    long_launches = bert_long_path(A, dev)
    card_memory("bert_long_path")
    packed_launches = bert_packed_path(A, dev)
    card_memory("bert_packed_path")
    executor_path(A, monitor, dev)
    card_memory("executor_path")
    encoder_serving_path(A, inference, monitor, dev)
    card_memory("encoder_serving_path")
    lenet_path(dev)
    card_memory("lenet_path")
    resnet_path(inference, dev)
    card_memory("resnet_path")
    deepfm_path(A, inference, dev)
    card_memory("deepfm_path")
    host_embedding_path(A, dev)
    card_memory("host_embedding_path")
    transformer_train_path(A, dev)
    card_memory("transformer_train_path")
    checkpoint_path(A, monitor, dev)
    card_memory("checkpoint_path")
    recompute_path(A, dev)
    card_memory("recompute_path")
    cold = served_fleet(A, inference, monitor, dev)
    card_memory("served_fleet")
    t0 = time.perf_counter()
    seq2seq_path(A, inference, dev)
    card_memory("seq2seq_path")
    book_path(A, monitor, dev)
    card_memory("book_path")
    emit(phase="book", check="phases_s",
         seq2seq_and_book_s=time.perf_counter() - t0)
    sentiment_path(A, monitor, dev)
    card_memory("sentiment_path")
    tagger_path(A, dev)
    card_memory("tagger_path")
    recommender_path(A, dev)
    card_memory("recommender_path")
    control_flow_path(A, dev)
    card_memory("control_flow_path")
    # the dense phase's model again (the same seed)
    model = T.Transformer.big(device=dev, seed=0)
    stream_launches = stream_path(T, A, inference, monitor, dev, model)
    card_memory("stream_path")
    spec_launches = speculative_path(T, A, inference, monitor, dev, model)
    del model
    card_memory("speculative_path")

    src = "paddle_tpu_torch/kernels/csrc/decode_attention.cu"
    kernels = []
    for name, rec, launches, replaces in (
            ("decode_attention", dense_rec, dense_launches,
             "paddle_tpu/kernels/attention.py:1653"),
            ("paged_attention", paged_rec, paged_launches,
             "paddle_tpu/kernels/attention.py:1829")):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, max_abs_err=rec["max_abs_err"],
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"], splits=rec["launch"]["splits"],
            ms_clean_l2=rec["kernel_ms_clean_l2"]))
    # the dense kernel's other paths: the stream's steps, the speculative
    # phase's draft steps (Q 1) and verify steps (Q k, causal window),
    # each counted over its own run; the verify shape timed apart
    kernels[0].update(
        launches_stream=stream_launches, launches_draft=spec_launches["draft"],
        launches_verify=spec_launches["verify"],
        verify={key: verify_rec[key] for key in (
            "B", "H", "Q", "C", "d", "max_abs_err", "kernel_ms",
            "kernel_ms_clean_l2", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    fused_src = "paddle_tpu_torch/kernels/csrc/fused_attention.cu"
    # each row counts its kernels' launches on the tensor cores (a
    # backward row the dq kernel's: the pair launches together): those
    # its wrapper made (``launches``: the phase's eager warm step; its
    # graph's replays call no wrapper) and those of one traced replay
    # of the graph, by kernel name (``replay_launches``)
    for name, rec, launches, replaces in (
            ("fused_attention_fwd (attn_fwd_tf32x3, fp32)", dict(
                fused_rec["fwd"], ms_p0=fused_p0_rec["fwd"]["kernel_ms"]),
             (bert_launches, FWD_TC), "paddle_tpu/kernels/attention.py:294"),
            ("fused_attention_bwd (attn_bwd_dq_tf32x3 + "
             "attn_bwd_dkdv_tf32x3, fp32)", fused_rec["bwd"],
             (bert_launches, DQ_TC), "paddle_tpu/kernels/attention.py:307"),
            ("fused_attention_fwd (attn_fwd_mma), long tier",
             long_rec["fwd"], (long_launches["long"], FWD_TC),
             "paddle_tpu/kernels/attention.py:362"),
            ("fused_attention_bwd (dq + dk/dv kernels), long tier",
             long_rec["bwd"], (long_launches["long"], DQ_TC),
             "paddle_tpu/kernels/attention.py:390"),
            ("fused_attention_fwd (attn_fwd_mma), flash tier",
             flash_rec["fwd"], (long_launches["flash"], FWD_TC),
             "paddle_tpu/kernels/attention.py:602"),
            ("fused_attention_bwd_dq (attn_bwd_dq_mma), flash tier",
             flash_rec["dq"], (long_launches["flash"], DQ_TC),
             "paddle_tpu/kernels/attention.py:650"),
            ("fused_attention_bwd_dkdv (attn_bwd_dkdv_mma), flash tier",
             flash_rec["dkdv"], (long_launches["flash"], DKDV_TC),
             "paddle_tpu/kernels/attention.py:697"),
            ("fused_attention_fwd (attn_fwd_mma), packed layout, packed "
             "tier", packed_rec["fwd"], (packed_launches["packed"], FWD_TC),
             "paddle_tpu/kernels/attention.py:917"),
            ("fused_attention_bwd (dq + dk/dv kernels), packed layout, "
             "packed tier", packed_rec["bwd"],
             (packed_launches["packed"], DQ_TC),
             "paddle_tpu/kernels/attention.py:960"),
            ("fused_attention_fwd (attn_fwd_mma), packed layout, resident "
             "tier", res_rec["fwd"], (packed_launches["resident"], FWD_TC),
             "paddle_tpu/kernels/attention.py:1170"),
            ("fused_attention_bwd_dq (attn_bwd_dq_mma), packed layout, "
             "resident tier", res_rec["dq"],
             (packed_launches["resident"], DQ_TC),
             "paddle_tpu/kernels/attention.py:1195"),
            ("fused_attention_bwd_dkdv (attn_bwd_dkdv_mma), packed layout, "
             "resident tier", res_rec["dkdv"],
             (packed_launches["resident"], DKDV_TC),
             "paddle_tpu/kernels/attention.py:1228")):
        (got, replayed), key = launches
        row = dict(
            name=name, route="cuda", source=fused_src, replaces=replaces,
            launches=got[key], replay_launches=replayed[key],
            max_abs_err=rec["max_abs_err"],
            ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"])
        for key in ("library_of", "ms_p0"):
            if key in rec:
                row[key] = rec[key]
        if replaces.endswith(":1170"):
            # the served encoder's attention forward: where the cold
            # replicas' library came from, and with how many nvcc runs
            row["served_from"] = cold
        kernels.append(row)
    # the sentinels each trace lost (host_launches): a trace that lost
    # all of them may have lost the first kernels of what it traced
    emit(phase="card", check="trace_sentinels", traces=len(TRACE_LOSSES),
         sentinels_a_trace=1 + TRACE_SENTINELS,
         traces_with_a_loss=sum(1 for n in TRACE_LOSSES if n),
         most_lost=max(TRACE_LOSSES, default=0),
         traces_lost_all=sum(1 for n in TRACE_LOSSES
                             if n == 1 + TRACE_SENTINELS))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
