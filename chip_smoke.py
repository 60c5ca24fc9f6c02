#!/usr/bin/env python3
"""Drive flexflow_tpu_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (PATH or $CUDA_HOME/bin); imports nothing
of JAX. Phases, each of which must pass or the script exits non-zero:

  1. build every CUDA kernel of the package from csrc/ (one nvcc each,
     all at once) into build/kernels/;
  2. kernels: each kernel against its plain PyTorch version on the card,
     in bf16 at the shapes the serving and training paths give it (and at
     edge shapes, in fp16 and f32 too), timed beside its plain version,
     its library counterpart where one exists, and its least possible
     time on an H100 (the bound);
  3. serving: the full-width causal LM (GPT-2 vocab 50257, width 1024, 12
     blocks of causal MHA with 16 heads of 64 + dense RELU + dense, bf16
     compute over f32 weights, max_len 512, 8 slots, 16-token pages) with
     random weights from a seed, through incremental_generate, the full
     forward (the flash kernel) as the oracle of the KV-cached logits, and
     a ContinuousBatcher answering ragged requests, each held against
     incremental_generate on its prompt. Their one-token steps replay the
     captured decode step (a CUDA graph over the cached bf16 weights);
     incremental_generate's eager steps must give the same tokens, and a
     warm step is traced both ways (wall, device busy, idle share, the
     bf16-cast family);
  4. training: the flagship Transformer (models/transformer.py: batch 8,
     seq 512, hidden 1024, 12 blocks of non-causal MHA with 16 heads of 64
     + dense RELU + dense, bias-free dense) with bf16 compute and bf16
     gradients over f32 weights, MSE loss, SGD at lr 0.01, random weights
     and data from seed 0 (bench.py's default workload). `FFModel.fit`
     takes a few steps on one batch (the loss must fall); then, with the
     weights rescaled to unit activations, `build_grad_step` through the
     flash kernels is held against the same step through the dense
     attention path (FF_ATTENTION_IMPL=dense), weight by weight;
  5. BERT: a BERT-base encoder written as a plain torch.nn.Module
     (models/bert.py: 12 post-LN layers, hidden 768, 12 heads of 64, GELU
     FFN 3072, attention and hidden dropout 0.1), imported through
     `frontends.torch.PyTorchModel`, batch 8, seq 512, bf16 compute over
     f32 weights, MSE-avg, SGD lr 0.01, data from seed 0. `fit` takes 4
     steps through the dropout variants of both flash kernels; `eval`
     must read lower after them than before; one step's gradients
     through the kernels are held against FF_ATTENTION_IMPL=dense under
     the same step seed (both draw the same masks), weight by weight;
  6. scans: `fit` with iterations_per_dispatch 4 (N train steps captured
     in one CUDA graph and replayed) over 9 Transformer batches, and over
     4 BERT batches with dropout, each against stepwise `fit` from the
     same weights and step seeds (equal epoch lines, bit-equal weights),
     samples/s of both over 5 ABBA rounds with their spread, and one
     traced scan dispatch (idle share). Every timed epoch and dispatch
     starts from the weights the equality check left and must leave
     finite weights. The BERT phase also times the standalone Dropout's
     keep-mask (int32 hash) against the int64 form of the same hash,
     bit-equal;
  7. remat: one BERT step's gradients with attention recomputed in the
     backward must equal the stored-residual gradients bit for bit;
  8. the CNN path. The bootcamp's AlexNet (BASELINE.md's AlexNet/CIFAR-10:
     batch 64, 3x229x229, 10 classes, f32, SGD lr 0.01, sparse CE with
     accuracy): the port's AlexNet nn.Module exported with
     `torch_to_flexflow` and replayed with `PyTorchModel(path).apply`,
     fed by `create_data_loader` over synthetic CIFAR-10 (32x32 images
     from a seed resized nearest to 229, labels by a fixed random
     projection), `init_layers`, `fit` stepwise and with
     iterations_per_dispatch 4 (bit-equal), the epoch CE falling, ABBA
     samples/s, a traced step and scan dispatch by kernel family (conv
     forward and backward, GEMM, pool, BN/elementwise, the optimizer's
     update alone), peak memory, and one step held against the same step
     in float64 on the card. ResNeXt-50 (build_resnext50, batch 16,
     224x224, groups 32): stepwise `fit` against the scan from the same
     weights and BatchNorm running statistics (both bit-equal), `eval` on
     the running statistics against a float64 recomputation from them,
     and the same readings. No hand-written kernel runs there: the
     convolutions are cuDNN's, as the JAX package's are XLA's;
  9. the rest of the OSDI'22 artifact's models and the MoE Transformer.
     The MoE Transformer (models/zoo.py build_moe_transformer: bench.py's
     moe leg at the flagship's batch 8, seq 512, hidden 1024, 16 heads,
     12 layers; 4 experts, top-2, capacity factor 1.2, lambda_bal 0.04;
     bf16 over f32, sparse CE, SGD lr 0.01): stepwise `fit` against the
     scan (bit-equal), the flash kernels on wgmma, the balance loss
     reaching every live gate, the share of (token, choice) pairs that
     capacity drops, and one step's loss and gradients against float64
     with the routing held to the run's own top-k (on weights rescaled
     to unit activations); DLRM (dlrm.cc's 4 tables of 1M x 64, batch
     64, f32): scan against stepwise, accuracy from `fit`, one step's
     gradients against float64; Inception-v3 (batch 64, 299x299, SGD
     momentum 0.9): scan against stepwise with momentum and every
     BatchNorm's running statistics, `eval` against a float64
     recomputation; CANDLE-Uno, MLP_Unify and XDL at their examples'
     sizes: scan against stepwise. Each with ABBA samples/s, peak
     memory, a traced step by family (the MoE dispatch/combine products
     and the embedding bags as families of their own) and a scan
     dispatch's idle share. No new kernel: the ops are library calls,
     as the JAX package's are XLA's;
 10. the long-context Transformer (models/zoo.py
     build_long_context_transformer at its defaults: batch 4, 32768
     positions, hidden 512, 8 heads of 64, 2 blocks, 10 classes a
     position; bf16 over f32, sparse CE, SGD lr 0.01). Both flash kernels
     at its attention shape (bh 32, 32768 x 32768, d 64), where they are
     bound by operations: the forward against chunked_attention in f32,
     the backward (dO live on a few blocks of queries, scaled so the
     gradients are of order 1) against the plain backward over those
     rows under the derived limit, each output also held to FLASH_NORM_TOL
     by the norm of its error (and a planted fault shown to fail that),
     each timed beside SDPA and its bound. Then stepwise fit against the scan (bit-equal,
     every flash launch on wgmma), the loss on one batch falling, ABBA
     samples/s, traces, peak memory, and the model's gradients at 4096
     positions against an f32 recomputation with dense attention;
 11. NMT (models/nmt.py build_nmt as examples/python/nmt.py -b 32 runs
     it, the config made through FFConfig.parse_args; 5 LSTMs x 32
     steps, vocabulary 8000, f32, SGD lr 0.1): stepwise fit against the
     scan (bit-equal), the epoch CE falling, ABBA samples/s, the stepwise
     step's idle share, one step's gradients against float64;
 12. --fusion: the flagship Transformer compiled with perform_fusion
     (one OP_FUSED node a block), fit stepwise and as a scan against the
     unfused model's fit from the same weights, bit for bit, and ABBA
     samples/s of the two;
 13. the Unity search: the flagship compiled with search_budget 10 in the
     measured mode (search/measure.py: each operator's forward and
     forward-with-backward timed at its shard shapes in CUDA graphs of R
     and 4R calls, the attention op through both flash kernels) on the
     default machine of H100s, for 1 worker and for 8 simulated workers
     (that winner exported to chiprun_out/ and read back by
     import_strategy). Every compute op of each winner must be priced
     from a finite measurement, no measurement may be below 0.9 x the
     bound of what its calls moved and computed, the measurement must
     launch both flash kernels on wgmma; each op type's measured times
     stand beside the analytic model's and the bound. Each winner,
     demoted to the one card, trains SEARCH_STEPS steps beside an
     unsearched compile from the same weights on the same batches: bit
     for bit where it keeps the lowering's compute ops;
 14. encoder-decoder serving: Transformer (big) (Vaswani et al. 2017,
     Table 3: d_model 1024, 16 heads, d_ff 4096, 6+6 post-LN blocks,
     sinusoidal position constants, vocab 32000; source 128, decoder cap
     128, bf16 over f32, random weights from the seed) through
     incremental_seq2seq_generate on two source batches in a row
     (captured steps against eager, cached logits against the full
     forward, the logit rows' spread above a floor) and
     incremental_beam_generate (4 beams: captured against eager, each
     beam rescored through the full forward, num_beams 1 against
     greedy); NMT's beam_generate at its published widths; a
     primitive-op attention decoder (batch_matmul with a baked tril
     mask, prefix caches, width 1024) decoded without assume_causal
     against its forward; compile_decode on the serving LM and a
     ContinuousBatcher on the decode executor. The encoder's flash
     forward (non-causal, 128 x 128) and the decoder's paged decode (cap
     128) are then held against their plain versions at those shapes;
 15. checkpoints and the resilient training loop: BERT-base (the BERT
     phase's widths, dropout on, SGD lr 1e-3 momentum 0.9, 12 batches
     from seed 0) through the resilient `fit` with the step guard (scale
     1024, regrowth every 3 good steps). Run A, a NaN step injected at
     index 4, checkpoints every 3 steps, the last 2 kept: the state after
     step 4 equals that after step 3 (device digests), the scale reads
     512 after step 4 and 1024 after step 7, one skip, the epoch line
     says skipped_steps=1. Run B, hard-killed before step 8, resumed by
     a fresh model from the step-6 checkpoint: weights, momentum and
     guard bit-equal to run A's. A resilient `fit` with checkpoints and
     no faults bit-equal to plain `fit`. In a telemetry session a
     corrupt newest checkpoint (the `bitflip` site, on disk) is skipped
     and counted. Every flash launch of those runs on wgmma. Readings:
     checkpoint bytes, save and restore ms, the guarded against the
     unguarded step (ABBA) beside the bound of the guard's bytes, and
     what the guard does with the BERT phase's lr 0.01 (a finding).
The kernel phase also holds both flash kernels' dropout variants against
their plain versions (the BERT shape and edges), checks the mask bit for
bit (V = I) and on a launch whose flat index passes 2^32. Bf16/fp16 flash
launches with d == dv in (64, 128) take the wgmma kernels (Hopper's
warpgroup products, TMA, accumulators in registers; kernels/attention.py
`flash_path`): every flash launch of the serving, training and BERT runs
must have taken them, and each check says which path it held. The
earlier WMMA kernels are checked and timed at the main shapes too
(`wmma_ms`, the same-card "before"). The 16-bit backward checks use the
derived limit (FLASH_BWD_TOL plus `flash_bwd_slack`), and report the
worst err/limit under the old limit beside it. The build report (ptxas
registers, spills, shared memory of every wgmma kernel) lands in
chiprun_out/chip_smoke.json; a wgmma kernel that spills fails the run.
Paged decode has two kernels (kernels/decode.py `paged_path`): the
cluster kernel (a (head, slot) row's live pages split over the 8 blocks
of a thread block cluster, partials merged in rank 0's shared memory)
takes every 16-bit launch with head dims multiples of 8, and every paged
launch of the serving run must have taken it; the earlier block kernel
takes the rest and is checked and timed at the main shapes too
(`block_ms`). Both are held against the plain version at the serving
shape and at a long one (4096 positions a slot), on the strided cache
view and on a scattered table with dead entries 2^30, and at edges;
their ptxas report lands in chip_smoke.json (a cluster instance that
spills fails the run). The serving phase also traces one warm decode
step (device busy, idle share, paged share, events a step).

Kernel times are the device time of each call, from a torch.profiler
trace (`time_ms`; the paged rows with the L2 flushed before each call,
the flush's own kernels left out); the flash and paged rows also carry
the earlier CUDA-event reading around each synchronised launch, which
holds the call's host time too. Launch counts are reset
just before each path is driven and read just after it; a replayed graph
adds the launches its capture recorded (kernels/build.py). Prints the
card's name and power limit, a `kernels` JSON line, a `serving`, a
`training`, a `training_scan`, a `bert`, a `bert_scan`, a `cnn` (after
the card's name and power limit), an `alexnet` and a `resnext` JSON
line, a `zoo_models` line (after the card's name and power limit), a
`moe`, a `dlrm`, an `inception` and a `zoo` line, a
`longctx_nmt_fusion` line (after the card's name and power limit; the
`kernels` line's flash rows carry their long-context shape's readings),
a `longctx`, an `nmt` and a `fusion` line, a `search`, a `seq2seq`
and a `resilience` line (the `kernels` line's flash and paged rows carry
their seq2seq shapes' readings; those lines after the
card's name and power limit) and, last, {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

# Kernel vs plain on the card: every element must meet
# |kernel - plain| <= atol + rtol * |plain|. A bf16 output step is at most
# 2^-7 of the value.
BF16_STEP = 2.0 ** -7
TOL = {
    # both versions keep every step in f32 and round only the output: one
    # output step, plus f32 summation order
    "paged_decode": (1e-5, BF16_STEP),
    # 16-bit: the kernel rounds P at the running row maximum, the plain
    # version at the final one, so O moves by a few 2^-9 relative steps of
    # P averaged over the row (atol: one bf16 step at |O| ~ 1), plus one
    # output step
    "flash_fwd": (4e-3, BF16_STEP),
    # f32: nothing is rounded but the summation order
    "flash_fwd_f32": (1e-5, 1e-5),
    # backward, 16-bit: the derived limit, kernels/attention.py
    # FLASH_BWD_TOL plus flash_bwd_slack per element (check_bwd_close)
    # backward, f32: summation order only, over up to 512 terms per output
    "flash_bwd_f32": (2e-6, 1e-5),
}
LSE_ATOL = 1e-5      # lse stays f32 in both
# The KV-cached logits against the full forward, on softmax outputs
# relative to their row's maximum. Through 12 layers each path rounds its
# activations (and P inside attention: the flash and dense paths round P
# to bf16, the paged kernel keeps it f32) to 8 significant bits at other
# places, so with unit-scale logits the outputs of the two paths differ by
# ~1.6% on average and by 3.36% at the worst of ~13M entries (this
# script's reading on an H100 80GB HBM3 at 700 W).
LOGIT_RTOL = 0.05

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN, SLOTS = 50257, 1024, 16, 12, 512, 8
# the training path: bench.py's default workload
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
# The gradient oracle, per weight: ||g_flash - g_dense|| over the norm of
# the op's dense gradient. Both steps round activations and gradients to
# bf16 at the op boundaries; inside attention the flash path rounds the
# unnormalised P and dS to bf16 and accumulates in f32, the dense path
# rounds the normalised probabilities and runs autograd's bf16 casts. The
# top block sees one attention's worth of those differences (a few 2^-9
# steps per element; the worst top-block reading is 0.025 of its op's
# norm); every block below adds its own, ~1% each, and carries the ones
# above on through its backward, so the gap grows with depth to 0.149 at
# the first block (readings on an H100 80GB HBM3, 700 W). The limits are
# twice those readings. A wiring fault (a lost scale, dq and dk swapped, a
# stale lse) moves a gradient by its own size.
ORACLE_RTOL = 0.3
ORACLE_TOP_RTOL = 0.05
# the BERT phase: BERT-base's published widths (google-research/bert
# uncased_L-12_H-768_A-12/bert_config.json) at bert_proxy.py's batch and
# sequence
BERT_BATCH, BERT_SEQ, BERT_STEPS = 8, 512, 4
BERT_LAYERS, BERT_HIDDEN, BERT_HEADS, BERT_FFN = 12, 768, 12, 3072
BERT_DROPOUT = 0.1
# Its gradient oracle, per weight over its op's dense gradient norm, as
# above: flash and dense draw the same masks, so what remains is where
# the two round. Residuals and LayerNorm keep those differences from
# compounding with depth: the worst reading is 0.00421 (layers_0_fc1.
# kernel; attention weights 0.00113) on an H100 80GB HBM3 at 700 W, and
# the limit is twice it. A mask that differs between the two paths, a
# lost 1/(1 - rate) or a mask left out of dP moves the attention
# gradients by a sizeable share of themselves.
BERT_ORACLE_RTOL = 0.0085
# The scans: fit with iterations_per_dispatch SCAN_SPD over SCAN_BATCHES
# Transformer batches (two captured chunks and a tail graph of one), and
# BERT_SCAN_SPD BERT steps with dropout (one chunk), each against
# stepwise fit from the same weights; samples/s of both over SCAN_ROUNDS
# ABBA rounds. The scan replays the stepwise step's kernels on the same
# data and seeds (cuBLAS picks the same kernels under capture on this
# card), so its weights must equal the stepwise ones bit for bit.
SCAN_SPD, SCAN_BATCHES, BERT_SCAN_SPD, SCAN_ROUNDS = 4, 9, 4, 5
# The CNN path. AlexNet: BASELINE.md's AlexNet/CIFAR-10 configuration,
# bootcamp_demo/ff_alexnet_cifar10.py -b 64 (3x229x229, 10 classes, f32,
# SGD lr 0.01, sparse CE with accuracy) over ALEX_BATCHES batches of
# synthetic CIFAR-10 for ALEX_EPOCHS epochs. ResNeXt-50:
# scripts/osdi22ae/resnext-50.sh (batch 16, 224x224, groups 32) over
# RESNEXT_BATCHES batches. Both stepwise and with iterations_per_dispatch
# CNN_SPD, compared bit for bit (the convolutions run cuDNN's
# deterministic algorithms, ops/conv2d.py), then CNN_ROUNDS ABBA rounds.
ALEX_BATCH, ALEX_HW, ALEX_CLASSES, ALEX_BATCHES, ALEX_EPOCHS = 64, 229, 10, 4, 3
RESNEXT_BATCH, RESNEXT_HW, RESNEXT_BATCHES = 16, 224, 8
CNN_SPD, CNN_ROUNDS = 4, 3
# AlexNet's oracle: one f32 train step against the same step in f64 on
# the card, per weight ||dW_f32 - dW_f64|| / ||dW_f64|| of its update.
# f32 convolutions run without TF32 (ops/conv2d.py), but cuDNN's
# heuristics pick FFT-based algorithms for some of them (the complex
# cf32 GEMMs in the trace): deterministic, and f32, but an FFT rounds
# relative to the norm of its whole transform, and a weight gradient
# sums 64 x 56 x 56 ~ 2e5 terms with heavy cancellation. The first
# reading on an H100 80GB HBM3 at 700 W was 2.05e-3 at conv1's kernel
# (each layer's error passes on to the ones below; 3e-4 in the dense
# layers); the limit is five times it. A wiring fault (a layout, a lost
# RELU, a pool's window) moves an update by its own size. The loss sums
# 64 terms: 1e-5 (read 1.1e-7). That the op's convolutions are full
# f32 (and not TF32) is held separately, per convolution against f64
# within 5e-5 (tests/test_torch_port_cuda.py).
ALEX_ORACLE_RTOL, ALEX_ORACLE_LOSS_RTOL = 1e-2, 1e-5
# ResNeXt-50's eval on the running statistics against the same forward
# recomputed in f64 from the model's weights and running statistics
# (F.batch_norm in eval mode): 53 normalised layers in f32, each adding
# a few 2^-24 of its activations; the CE's logs keep that relative to
# the logits. Limit 1e-3 on the mean CE; the same forward on batch
# statistics must read further off than that.
RESNEXT_EVAL_RTOL = 1e-3
# The rest of the OSDI'22 artifact's models and the MoE Transformer. The
# MoE Transformer: bench.py's moe leg (FF_BENCH_WORKLOAD=moe) at the
# flagship's sizes (TRAIN_SEQ, HIDDEN, HEADS) over MOE_BATCHES batches,
# stepwise and as one scan of MOE_SPD.
MOE_BATCH, MOE_LAYERS, MOE_CLASSES = 8, 12, 10
MOE_EXPERTS, MOE_TOPK, MOE_CAPACITY, MOE_LAMBDA = 4, 2, 1.2, 0.04
MOE_BATCHES, MOE_SPD = 4, 4
MOE_OPS_A_LAYER = 12   # attention, 2 reshapes, gate, top_k, group_by,
#                        softmax, 4 experts, aggregate
# Its oracle: one step's loss and gradients against float64 with the
# routing fixed, on weights rescaled to unit activations, per weight over
# its op's f64 gradient norm as the Transformer's oracle reads it. In
# bf16 the rounding compounds through 12 layers without residuals or
# norms as in the Transformer, and more: attention averages the tokens
# until a layer's inputs differ from token to token by about one bf16
# step, and a kernel's gradient sums those differences. At 2 layers the
# worst weight reads 0.0568 and the median 0.0013; at 12 the worst 2.895
# (a layer-3 gate kernel) and the median 0.0164, the top layer (the last
# MoE layer and the classifier) 0.1654, the loss 8.62e-4. In f32 at 12
# layers the worst reads 6.43e-4 and the median 5.5e-6 (readings on an
# H100 80GB HBM3, 700 W). So the bf16 run holds its loss and its top
# layer, at twice their readings, and an f32 run of the same step holds
# every weight, at three times its reading; a wiring fault (a lost gate
# weight or balance term, a routing or slot off by one) moves a gradient
# by its own size.
MOE_ORACLE_LOSS_RTOL, MOE_ORACLE_TOP_RTOL = 2e-3, 0.33
MOE_F32_LOSS_RTOL, MOE_F32_RTOL = 1e-5, 2e-3
# DLRM (dlrm.cc's defaults, batch 64 as scripts/osdi22ae/dlrm.sh runs
# it), Inception-v3 (examples/python/inception.py, batch 64) and the
# others at batch 64, each over a few batches, stepwise and as scans of
# ZOO_SPD, ZOO_ROUNDS ABBA rounds.
DLRM_BATCH, DLRM_ROWS, DLRM_BATCHES = 64, 1000000, 8
INCEPTION_BATCH, INCEPTION_HW, INCEPTION_CLASSES = 64, 299, 1000
INCEPTION_BATCHES = 4
ZOO_BATCH, ZOO_BATCHES, XDL_ROWS = 64, 4, 100000
ZOO_SPD, ZOO_ROUNDS = 4, 3
# DLRM's oracle: one f32 step's gradients against float64. Its matrix
# products are full f32 (no TF32) over at most 256 terms, and the bags
# gather one row each: a few 2^-24 of each value per layer through 6
# layers, ~1e-6 of a gradient. Limit 1e-4 per weight gradient, 1e-5 on
# the loss.
ZOO_ORACLE_RTOL, ZOO_ORACLE_LOSS_RTOL = 1e-4, 1e-5
# The long-context Transformer (models/zoo.py build_long_context_transformer
# at its defaults, the JAX package's: batch 4, 32768 positions, hidden
# 512, 8 heads of 64, 2 blocks, 10 classes a position), bf16 over f32 as
# bench.py's longctx leg, sparse CE, SGD lr 0.01, over LC_BATCHES batches
# stepwise and as one scan of LC_SPD; its labels are skewed (class c drawn
# with weight 1/(c+1)), so the classifier has something to learn that
# attention averaging over 32768 tokens cannot wash out, and the loss on
# a batch falls within LC_STEPS steps.
LC_BATCH, LC_SEQ, LC_HIDDEN, LC_HEADS, LC_LAYERS, LC_CLASSES = \
    4, 32768, 512, 8, 2, 10
LC_BATCHES, LC_SPD, LC_STEPS, LC_ROUNDS = 4, 4, 4, 3
# The flash backward at 32768 positions is held on LC_BWD_BLOCKS blocks
# of LC_BWD_ROWS queries with dO live (elsewhere dO = 0, so those rows'
# dS is exactly 0 and dq, dk, dv come from the live blocks alone): the
# plain backward over those rows against all 32768 keys fits in f32.
LC_BWD_BLOCKS, LC_BWD_ROWS = 3, 128
# At this length |O| is ~sqrt(e / 32768) ~ 0.009 and, with dO ~ N(0, 1)
# on 384 rows, |dk| and |dv| ~ 1e-3: under the per-element limits' atol
# (4e-3 forward, 3e-3 backward) an error of half a value would pass. So
# the live dO is scaled by LC_DO_SCALE (a power of two: exact in bf16,
# and every product and rounding of the backward scales with it), which
# puts dk and dv near 1 and leaves the derived limit's rtol and slack,
# which scale with the values, to decide; and each of O, dq, dk, dv is
# also held to FLASH_NORM_TOL by ||err|| / ||ref||, which no scale
# moves. The forward's values stay as they are: its error is P's
# rounding, which does not shrink with |O| where O crosses 0, so the
# per-element limit holds it only at this |O|, and the norm check is
# what sees a fault of a few percent of O there. A planted fault (one
# K/V tile of LC_BWD_ROWS keys dropped from the forward; dv * 1.5 and
# one tile of dk zeroed) must fail the norm check.
LC_DO_SCALE = 2.0 ** 10
# Its gradient oracle at LC_ORACLE_SEQ positions (the same widths), where
# dense f32 attention fits: one bf16 step (flash kernels) against the
# same step recomputed in f32 with dense attention, per weight over its
# op's f32 gradient norm. Predicted before the first reading from the MoE
# Transformer's two-layer bf16 reading (worst 0.0568 against f64): twice
# that; the loss as the MoE oracle's, 2e-3. A wiring fault moves a
# gradient by its own size.
LC_ORACLE_SEQ, LC_ORACLE_RTOL, LC_ORACLE_LOSS_RTOL = 4096, 0.12, 2e-3
# NMT as examples/python/nmt.py -b 32 runs it (batch 32, vocab 8000 both
# sides, 32 positions each, embed 256, hidden 512, 2 layers, SGD lr 0.1,
# sparse CE, f32) over its 4 batches for NMT_EPOCHS epochs, stepwise and
# as one scan of NMT_SPD.
NMT_BATCH, NMT_VOCAB, NMT_LEN, NMT_EPOCHS, NMT_SPD = 32, 8000, 32, 4, 4
# Its oracle: one f32 step's gradients against float64 (an LSTM loop of
# our own in plain torch), per weight ||g - g64|| / ||g64||. Each step's
# f32 products and gates round at 2^-24 of their values, and the
# recurrence carries them through 32 steps and five stacked LSTMs into
# the backward through time: ~1e-5 predicted; limit 1e-3, the loss 1e-5.
NMT_ORACLE_RTOL, NMT_ORACLE_LOSS_RTOL = 1e-3, 1e-5
# --fusion: the flagship Transformer (bench.py's default leg) compiled
# with perform_fusion, FUSION_BATCHES batches, stepwise and as scans of
# SCAN_SPD, against the unfused model from the same weights.
FUSION_BATCHES, FUSION_ROUNDS = 8, 2


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _device_events(torch, prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def time_ms(fn, iters, flush=None, per_launch=False):
    """Mean device time of fn() in ms over `iters` calls after a warm-up.
    By default, the summed durations of the kernels the calls launch, from
    a torch.profiler (CUPTI) trace: a kernel's Python wrapper can take
    longer than its kernel (~0.05 ms a call on the H100 host of PERF.md),
    and CUDA events, even around back-to-back launches, would then read the
    host. `flush` (run before each call) evicts the L2 so each call finds
    its operands cold, as the serving path does (each layer reads its own
    cache); the flush's own kernels (the names a trace of one flush shows)
    are left out of the sum. With `per_launch`, CUDA events around each
    call and a synchronize between calls (the earlier method): each
    reading then also holds the host time of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    if not per_launch:
        skip = set()
        if flush is not None:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                flush()
                torch.cuda.synchronize()
            skip = {e.name for e in _device_events(torch, prof)}
        # a trace now and then comes back without device events (CUPTI on
        # the H100 host of PERF.md, once in a run of hundreds): trace again
        for attempt in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    if flush is not None:
                        flush()
                    fn()
                torch.cuda.synchronize()
            device = [e for e in _device_events(torch, prof)
                      if e.name not in skip]
            if device:
                return (sum(e.time_range.elapsed_us() for e in device)
                        / iters / 1e3)
            log(f"  time_ms: the profiler saw no device time (trace "
                f"{attempt + 1} of 3)")
        raise AssertionError("the profiler saw no device time")
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def host_ms(torch, fn, calls=100):
    """Host time of one call of `fn`: `calls` calls enqueued without a
    synchronize (the launch queue holds them), over the wall clock."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / calls


def check_close(what, which, out, ref):
    """Hold `out` against `ref` under TOL[which]; returns the largest
    absolute error and the largest error over its limit (<= 1 passes)."""
    atol, rtol = TOL[which]
    err = (out.float() - ref.float()).abs()
    ratio = (err / (atol + rtol * ref.float().abs())).max().item()
    emax = err.max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: max err {emax}, worst err/limit "
                             f"{ratio} (atol {atol}, rtol {rtol})")
    return emax, ratio


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def expect_path(what, before, family, path):
    """The launch since `before` (a copy of build.path_counts) went
    through `path` of `family` and no other path."""
    from flexflow_tpu_torch.kernels import build

    got = {k: build.path_counts[k] - before[k] for k in build.path_counts
           if k.startswith(family)}
    want = {k: int(k == f"{family}_{path}") for k in got}
    if got != want:
        raise AssertionError(f"{what}: launches by path {got}, expected "
                             f"one on {path}")


def check_bwd_close(what, got, ref, slack, dtype):
    """Hold a backward's (dq, dk, dv) against the plain version's. 16-bit:
    under FLASH_BWD_TOL plus `flash_bwd_slack` (the derived limit), with
    the worst err/limit under the old limit (FLASH_BWD_TOL alone, the
    limits read from earlier runs) reported beside it; f32: under
    TOL["flash_bwd_f32"].
    Returns (max abs err, worst err/limit old, worst err/limit new)."""
    import torch

    from flexflow_tpu_torch.kernels import attention as ka

    if dtype == torch.float32:
        atol, rtol = TOL["flash_bwd_f32"]
        slack = (0.0, 0.0, 0.0)
    else:
        atol, rtol = ka.FLASH_BWD_TOL[dtype]
    emax = old = new = 0.0
    for name, a, b, s in zip(("dq", "dk", "dv"), got, ref, slack):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what} {name}: non-finite")
        err = (a.float() - b.float()).abs()
        lim = atol + rtol * b.float().abs()
        r_old = (err / lim).max().item()
        r_new = (err / (lim + s)).max().item()
        if not r_new <= 1.0:
            raise AssertionError(f"{what} {name}: max err {err.max().item()}, "
                                 f"worst err/limit {r_new} (derived limit; "
                                 f"{r_old} under atol {atol}, rtol {rtol})")
        emax, old, new = max(emax, err.max().item()), max(old, r_old), \
            max(new, r_new)
    return emax, old, new


def check_flash(torch, rng_seed=0):
    from flexflow_tpu_torch.kernels import attention as ka
    from flexflow_tpu_torch.kernels import build

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16 = "cuda", torch.bfloat16
    worst = {"o": 0.0, "ratio": 0.0, "lse": 0.0}

    def one(bh, sq, sk, d, dv, causal, dtype=bf16, path=None):
        q = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
        v = torch.randn(bh, sk, dv, generator=g, device=dev).to(dtype)
        path = path or ka.flash_path(dtype, d, dv)
        before = dict(build.path_counts)
        o, lse = ka._flash_fwd_cuda(q, k, v, causal=causal, _path=path)
        po, plse = ka.flash_fwd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        what = (f"flash bh={bh} sq={sq} sk={sk} d={d} dv={dv} "
                f"causal={causal} {str(dtype)[6:]} {path}")
        expect_path(what, before, "flash_fwd", path)
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{what}: non-finite")
        eo, ratio = check_close(what, "flash_fwd_f32" if dtype ==
                                torch.float32 else "flash_fwd", o, po)
        el = (lse - plse).abs().max().item()
        if not el <= LSE_ATOL:
            raise AssertionError(f"{what}: lse err {el} (tol {LSE_ATOL})")
        worst["lse"] = max(worst["lse"], el)
        if dtype != torch.float32:   # the serving dtypes' worst
            worst["o"] = max(worst["o"], eo)
            worst["ratio"] = max(worst["ratio"], ratio)
        log(f"  {what}: max|O-plain|={eo:.3g} (err/limit {ratio:.3g}) "
            f"max|lse-plain|={el:.3g}")
        return q, k, v

    # the serving shape: 8 rows x 16 heads, 512 x 512, d 64, causal
    q, k, v = one(128, 512, 512, 64, 64, True)
    qn, kn, vn = one(128, 512, 512, 64, 64, False)   # the training shape
    # the wgmma kernel at its edges: d = dv = 128, ragged lengths both
    # ways, causal with more queries than keys, fp16
    one(16, 512, 512, 128, 128, False)
    one(16, 512, 512, 128, 128, True)
    one(8, 100, 300, 64, 64, False)      # ragged, not multiples of a tile
    one(8, 300, 100, 64, 64, True)       # more queries than keys
    one(8, 129, 257, 64, 64, True)
    one(8, 300, 100, 128, 128, True)
    one(8, 129, 257, 128, 128, False)
    one(8, 64, 64, 64, 64, True, torch.float16)
    one(8, 129, 257, 128, 128, True, torch.float16)
    # the WMMA kernel: other 16-bit head dims, and at the main shape (its
    # time is the "before" figure below)
    one(128, 512, 512, 64, 64, True, path="wmma")
    one(16, 512, 512, 64, 32, True)      # dv != d
    one(16, 512, 512, 64, 128, True)
    one(8, 300, 100, 128, 64, True)
    # the CUDA-core kernel: head dims not multiples of 16, and f32
    one(8, 200, 200, 40, 24, True)
    one(16, 512, 512, 64, 64, True, torch.float32)
    one(8, 90, 130, 20, 36, False, torch.float32)
    bh, s, d = 128, 512, 64
    t_k = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, causal=True), 50)
    t_w = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, causal=True,
                                             _path="wmma"), 50)
    t_p = time_ms(lambda: ka.flash_fwd_plain(q, k, v, causal=True), 10)
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 50)
    t_ks = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, causal=True), 50,
                   per_launch=True)
    t_ls = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 50, per_launch=True)
    pairs = bh * s * (s + 1) // 2            # causal (query, key) pairs
    flops = pairs * (2 * d + 2 * d)          # QK^T and PV
    nbytes = 2 * (3 * bh * s * d + bh * s * d) + 4 * bh * s
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  flash serving shape: kernel {t_k:.4f} ms (WMMA {t_w:.4f}), "
        f"plain {t_p:.4f} ms, SDPA {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"per launch synced: kernel {t_ks:.4f}, SDPA {t_ls:.4f}")
    # the training shape: the same operands, not causal
    tt_k = time_ms(lambda: ka._flash_fwd_cuda(qn, kn, vn, causal=False), 50)
    tt_w = time_ms(lambda: ka._flash_fwd_cuda(qn, kn, vn, causal=False,
                                              _path="wmma"), 50)
    tt_p = time_ms(lambda: ka.flash_fwd_plain(qn, kn, vn, causal=False), 10)
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (qn, kn, vn))
    tt_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4), 50)
    tt_ks = time_ms(lambda: ka._flash_fwd_cuda(qn, kn, vn, causal=False), 50,
                    per_launch=True)
    tt_ls = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4), 50, per_launch=True)
    tb_ms, tb_by = bound_ms(nbytes, bh * s * s * (2 * d + 2 * d))
    log(f"  flash training shape: kernel {tt_k:.4f} ms (WMMA {tt_w:.4f}), "
        f"plain {tt_p:.4f} ms, SDPA {tt_l:.4f} ms, bound {tb_ms:.4f} ms "
        f"({tb_by}); kernel/SDPA {tt_k / tt_l:.3f}, kernel/WMMA "
        f"{tt_k / tt_w:.3f}; per launch synced: kernel {tt_ks:.4f}, SDPA "
        f"{tt_ls:.4f}")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "flexflow_tpu/kernels/attention.py:183",
            "max_abs_err": worst["o"], "err_over_limit": worst["ratio"],
            "tol": TOL["flash_fwd"], "lse_max_abs_err": worst["lse"],
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l, "wmma_ms": t_w, "ms_per_launch_synced": t_ks,
            "library_ms_per_launch_synced": t_ls,
            "shape": "bh=128 sq=sk=512 d=dv=64 causal bf16, L2 warm",
            "training_shape": {
                "shape": "bh=128 sq=sk=512 d=dv=64 non-causal bf16, L2 warm",
                "ms": tt_k, "plain_ms": tt_p, "bound_ms": tb_ms,
                "bound_by": tb_by, "library_ms": tt_l, "wmma_ms": tt_w,
                "over_library": tt_k / tt_l, "over_wmma": tt_k / tt_w,
                "ms_per_launch_synced": tt_ks,
                "library_ms_per_launch_synced": tt_ls}}


def check_flash_bwd(torch, rng_seed=2):
    from flexflow_tpu_torch.kernels import attention as ka
    from flexflow_tpu_torch.kernels import build

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16 = "cuda", torch.bfloat16
    worst = {}   # dtype name -> (max abs err, err/limit old, err/limit new)

    def one(bh, sq, sk, d, dv, causal, dtype=bf16, path=None):
        q, k, do = (torch.randn(bh, n, c, generator=g, device=dev).to(dtype)
                    for n, c in ((sq, d), (sk, d), (sq, dv)))
        v = torch.randn(bh, sk, dv, generator=g, device=dev).to(dtype)
        path = path or ka.flash_path(dtype, d, dv)
        o, lse = ka._flash_fwd_cuda(q, k, v, causal=causal, _path=path)
        before = dict(build.path_counts)
        got = ka._flash_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                 _path=path)
        ref = ka.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
        slack = ka.flash_bwd_slack(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        what = (f"flash_bwd bh={bh} sq={sq} sk={sk} d={d} dv={dv} "
                f"causal={causal} {str(dtype)[6:]} {path}")
        expect_path(what, before, "flash_bwd", path)
        e, r_old, r_new = check_bwd_close(what, got, ref, slack, dtype)
        key = str(dtype)[6:]
        w = worst.get(key, (0.0, 0.0, 0.0))
        worst[key] = (max(w[0], e), max(w[1], r_old), max(w[2], r_new))
        log(f"  {what}: max|grad-plain| {e:.3g}, err/limit {r_new:.3g} "
            f"(old limit {r_old:.3g})")
        return q, k, v, o, lse, do

    # the training shape: 8 rows x 16 heads, 512 x 512, d 64, not causal
    q, k, v, o, lse, do = one(128, 512, 512, 64, 64, False)
    one(128, 512, 512, 64, 64, True)
    # the wgmma kernels at their edges
    one(16, 512, 512, 128, 128, False)
    one(16, 512, 512, 128, 128, True)
    one(8, 100, 300, 64, 64, False)       # ragged, fewer queries than keys
    one(8, 300, 100, 64, 64, True)        # more queries than keys
    one(8, 64, 160, 64, 64, True)         # keys no query sees
    one(8, 129, 257, 64, 64, True)
    one(8, 300, 100, 128, 128, True)
    one(8, 129, 257, 128, 128, False)
    one(8, 256, 256, 64, 64, True, torch.float16)
    one(8, 129, 257, 128, 128, True, torch.float16)
    # the WMMA kernels: at the main shape, and other 16-bit head dims
    one(128, 512, 512, 64, 64, False, path="wmma")
    one(16, 512, 512, 64, 32, True)       # dv != d
    one(8, 300, 100, 128, 64, True)
    one(8, 200, 200, 256, 256, True)      # 2 warps a block
    # the CUDA-core kernels: f32, and head dims not multiples of 16
    one(16, 512, 512, 64, 64, True, torch.float32)
    one(8, 90, 130, 20, 36, False, torch.float32)
    one(8, 200, 200, 40, 24, True)
    # no atomics: the same inputs give the same bits, run after run
    first = ka._flash_bwd_cuda(q, k, v, o, lse, do, causal=False)
    for _ in range(3):
        again = ka._flash_bwd_cuda(q, k, v, o, lse, do, causal=False)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError("flash_bwd at the training shape: two runs "
                                 "on the same inputs differ")
    log("  flash_bwd training shape: 4 runs bit-equal")
    bh, s, d = 128, 512, 64
    t_k = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                             causal=False), 50)
    t_w = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                             causal=False, _path="wmma"), 50)
    t_p = time_ms(lambda: ka.flash_bwd_plain(q, k, v, o, lse, do,
                                             causal=False), 5)
    # the yardstick: SDPA's backward alone, through autograd
    q4, k4, v4 = (x.view(TRAIN_BATCH, HEADS, s, d).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
    do4 = do.view(TRAIN_BATCH, HEADS, s, d)
    t_l = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                              retain_graph=True), 50)
    t_ks = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                              causal=False), 50,
                   per_launch=True)
    t_ls = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                               retain_graph=True), 50,
                   per_launch=True)
    # five products of 2*bh*s*s*d; q, k, v, O, dO read, dq, dk, dv
    # written (bf16), lse read (f32)
    flops = 5 * 2 * bh * s * s * d
    nbytes = 2 * 8 * bh * s * d + 4 * bh * s
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  flash_bwd training shape: kernel {t_k:.4f} ms (WMMA {t_w:.4f}), "
        f"plain {t_p:.4f} ms, SDPA backward {t_l:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}); kernel/SDPA {t_k / t_l:.3f}, kernel/WMMA "
        f"{t_k / t_w:.3f}; per launch synced: kernel {t_ks:.4f}, SDPA "
        f"{t_ls:.4f}")
    return {"name": "flash_bwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "flexflow_tpu/kernels/attention.py:233",
            "max_abs_err": worst["bfloat16"][0],
            "err_over_limit": worst["bfloat16"][2],
            "err_over_old_limit": worst["bfloat16"][1],
            "tol": "FLASH_BWD_TOL + flash_bwd_slack (16-bit); "
                   f"{TOL['flash_bwd_f32']} (f32)",
            "by_dtype": {n: {"max_abs_err": e, "err_over_old_limit": ro,
                             "err_over_limit": rn}
                         for n, (e, ro, rn) in worst.items()},
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l, "wmma_ms": t_w,
            "over_library": t_k / t_l, "over_wmma": t_k / t_w,
            "ms_per_launch_synced": t_ks,
            "library_ms_per_launch_synced": t_ls, "bit_equal_runs": 4,
            "shape": "bh=128 sq=sk=512 d=dv=64 non-causal bf16, L2 warm; "
                     "library: scaled_dot_product_attention backward"}


DROP_SEEDS = (0x9E3779B9, 0x01234567)


def check_flash_dropout(torch, rng_seed=3):
    """The dropout variants of both flash kernels against their plain
    versions (the same limits: both scale the kept P and dP before they
    round, and the mask is exact): at the BERT shape and at edges; the
    mask bit for bit (V = I: O is exactly 0 where an element was dropped);
    a launch whose flat index bh*sq*sk passes 2^32, its rows past the wrap
    held against the plain version at their row offset; each variant
    timed beside its plain version, the WMMA kernel and SDPA with
    dropout_p=0.1 (the same work with another mask). Returns the two
    kernel entries."""
    from flexflow_tpu_torch.kernels import attention as ka
    from flexflow_tpu_torch.kernels import build

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16 = "cuda", torch.bfloat16
    tol_fwd = {torch.bfloat16: "flash_fwd", torch.float16: "flash_fwd",
               torch.float32: "flash_fwd_f32"}
    worst = {"fwd": (0.0, 0.0), "bwd": (0.0, 0.0, 0.0)}

    def note(which, *vals):
        worst[which] = tuple(max(a, b) for a, b in zip(worst[which], vals))

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def one(bh, sq, sk, d, dv, causal, rate, dtype=bf16):
        q, k, do = rand(bh, sq, d, dtype=dtype), rand(bh, sk, d, dtype=dtype), \
            rand(bh, sq, dv, dtype=dtype)
        v = rand(bh, sk, dv, dtype=dtype)
        kw = dict(causal=causal, dropout=rate, seeds=DROP_SEEDS)
        path = ka.flash_path(dtype, d, dv)
        before = dict(build.path_counts)
        o, lse = ka._flash_fwd_cuda(q, k, v, **kw)
        po, plse = ka.flash_fwd_plain(q, k, v, **kw)
        got = ka._flash_bwd_cuda(q, k, v, o, lse, do, **kw)
        ref = ka.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        slack = ka.flash_bwd_slack(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        what = (f"flash dropout {rate} bh={bh} sq={sq} sk={sk} d={d} dv={dv} "
                f"causal={causal} {str(dtype)[6:]} {path}")
        expect_path(what, before, "flash_fwd", path)
        expect_path(what, before, "flash_bwd", path)
        if not all(torch.isfinite(x).all() for x in (o, lse)):
            raise AssertionError(f"{what}: non-finite")
        e, ratio = check_close(what, tol_fwd[dtype], o, po)
        note("fwd", e, ratio)
        el = (lse - plse).abs().max().item()
        if not el <= LSE_ATOL:
            raise AssertionError(f"{what}: lse err {el} (tol {LSE_ATOL})")
        eb, r_old, r_new = check_bwd_close(what, got, ref, slack, dtype)
        note("bwd", eb, r_old, r_new)
        log(f"  {what}: O {e:.3g} ({ratio:.3g}); grads {eb:.3g}, err/limit "
            f"{r_new:.3g} (old limit {r_old:.3g})")
        return q, k, v, o, lse, do

    # the BERT shape: 8 rows x 12 heads, 512 x 512, d 64, rate 0.1
    bert = one(96, 512, 512, 64, 64, False, 0.1)
    # the 16-bit causal edge that read err/limit 1.27 under the old limit
    one(96, 512, 512, 64, 64, True, 0.1)
    # the wgmma kernels at rates 0.1 and 0.5: ragged, causal with more
    # queries than keys, d = dv = 128, fp16
    one(8, 512, 512, 64, 64, True, 0.5)
    one(8, 100, 300, 64, 64, False, 0.5, torch.float16)
    one(8, 300, 100, 64, 64, True, 0.1)
    one(8, 129, 257, 64, 64, True, 0.5, torch.float16)
    one(8, 129, 257, 128, 128, True, 0.1)
    one(8, 300, 100, 128, 128, False, 0.5, torch.float16)
    # the WMMA and CUDA-core kernels: odd lengths, causal, d = dv = 16 and
    # 256, f32
    one(8, 300, 100, 64, 32, True, 0.1, torch.float32)
    one(8, 200, 200, 256, 256, False, 0.1, torch.float16)  # 2 warps (bwd)
    one(8, 130, 90, 16, 16, False, 0.5, torch.float32)
    one(8, 129, 257, 16, 16, False, 0.1, torch.float16)

    # the mask bit for bit: with V = I (dv = sk) column j of O is key j's
    # probability over l, exactly 0 where the kernel dropped it. d = dv =
    # sk = 64 and 128 take the wgmma kernel, the others WMMA and the CUDA
    # cores
    for dtype, d, sk in ((bf16, 64, 64), (bf16, 128, 128),
                         (torch.float16, 128, 128), (bf16, 64, 256),
                         (torch.float32, 64, 256), (bf16, 40, 256)):
        bh, sq = 48, 512
        q, k = rand(bh, sq, d, dtype=dtype), rand(bh, sk, d, dtype=dtype)
        v = torch.eye(sk, dtype=dtype, device=dev).expand(bh, sk, sk)
        path = ka.flash_path(dtype, d, sk)
        before = dict(build.path_counts)
        o, _ = ka._flash_fwd_cuda(q, k, v.contiguous(), causal=False,
                                  dropout=0.1, seeds=DROP_SEEDS)
        keep = ka.attention_dropout_mask(DROP_SEEDS, 0.1, bh, sq, sk,
                                         device=dev)
        torch.cuda.synchronize()
        expect_path("mask check", before, "flash_fwd", path)
        bad = int(((o != 0) != keep).sum())
        if bad:
            raise AssertionError(f"dropout mask ({str(dtype)[6:]}, d {d}, "
                                 f"{path}): {bad} of {keep.numel()} elements "
                                 "differ")
        log(f"  mask bit for bit ({str(dtype)[6:]}, d = {d}, sk = dv = {sk}, "
            f"{path}): {keep.numel()} elements, kept "
            f"{keep.float().mean().item():.5f}")

    # a launch whose flat index passes 2^32: rows r with r*sq*sk >= 2^32
    # hash wrapped indices (row 4096 starts at 2^32 here)
    bh, s, d = 4100, 1024, 64
    if bh * s * s <= 2 ** 32:
        raise AssertionError("wrap check does not pass 2^32")
    q, k, v, do = (rand(bh, s, d) for _ in range(4))
    kw = dict(causal=False, dropout=0.1, seeds=DROP_SEEDS)
    o, lse = ka._flash_fwd_cuda(q, k, v, **kw)
    got = ka._flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    r0 = 4094
    rows = slice(r0, bh)
    part = [x[rows].contiguous() for x in (q, k, v, o, lse, do)]
    po, plse = ka.flash_fwd_plain(*part[:3], _row0=r0, **kw)
    ref = ka.flash_bwd_plain(*part, _row0=r0, **kw)
    slack = ka.flash_bwd_slack(*part, _row0=r0, **kw)
    torch.cuda.synchronize()
    check_close("wrap rows O", "flash_fwd", o[rows], po)
    check_bwd_close("wrap rows", [x[rows] for x in got], ref, slack, bf16)
    unwrapped = ka.flash_fwd_plain(*part[:3], **kw)[0]   # rows taken as 0..5
    if torch.equal(unwrapped, po):
        raise AssertionError("wrap check: the row offset changed nothing")
    log(f"  rows {r0}..{bh - 1} of a bh={bh} sq=sk={s} launch "
        f"(flat index to {bh * s * s}, past 2^32): kernel = plain at row "
        "offset, forward and backward")
    del q, k, v, do, o, lse, got, part
    torch.cuda.empty_cache()

    # timings at the BERT shape
    q, k, v, o, lse, do = bert
    bh, s, d = 96, 512, 64
    kw = dict(causal=False, dropout=0.1, seeds=DROP_SEEDS)
    t_f = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, **kw), 50)
    t_fw = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, _path="wmma", **kw),
                   50)
    t_fp = time_ms(lambda: ka.flash_fwd_plain(q, k, v, **kw), 5)
    t_b = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do, **kw), 50)
    t_bw = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                              _path="wmma", **kw), 50)
    t_bp = time_ms(lambda: ka.flash_bwd_plain(q, k, v, o, lse, do, **kw), 5)
    t_f0 = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, causal=False), 50)
    t_b0 = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                              causal=False), 50)
    b4 = TRAIN_BATCH
    q4, k4, v4 = (x.view(b4, bh // b4, s, d).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_fl = time_ms(lambda: sdpa(q4, k4, v4, dropout_p=0.1), 50)
    out = sdpa(q4, k4, v4, dropout_p=0.1)
    do4 = do.view(b4, bh // b4, s, d)
    t_bl = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                               retain_graph=True), 50)
    t_fs = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, **kw), 50,
                   per_launch=True)
    t_fls = time_ms(lambda: sdpa(q4, k4, v4, dropout_p=0.1), 50,
                    per_launch=True)
    t_bs = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do, **kw), 50,
                   per_launch=True)
    t_bls = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                                retain_graph=True), 50,
                    per_launch=True)
    # forward: q, k, v read, O written (bf16), lse written (f32); QK^T and
    # PV. Backward: q, k, v, O, dO read, dq, dk, dv written, lse read;
    # five products. The mask adds no bytes; its hash (~22 integer
    # operations per score element) has no rate in the bound's table.
    f_ms, f_by = bound_ms(2 * 4 * bh * s * d + 4 * bh * s,
                          bh * s * s * (2 * d + 2 * d))
    b_ms, b_by = bound_ms(2 * 8 * bh * s * d + 4 * bh * s,
                          5 * 2 * bh * s * s * d)
    log(f"  flash_fwd dropout 0.1 at the BERT shape: kernel {t_f:.4f} ms "
        f"(WMMA {t_fw:.4f}, no dropout {t_f0:.4f}), plain {t_fp:.4f} ms, "
        f"SDPA(dropout_p=0.1) {t_fl:.4f} ms, bound {f_ms:.4f} ms ({f_by}); "
        f"per launch synced: kernel {t_fs:.4f}, SDPA {t_fls:.4f}")
    log(f"  flash_bwd dropout 0.1 at the BERT shape: kernel {t_b:.4f} ms "
        f"(WMMA {t_bw:.4f}, no dropout {t_b0:.4f}), plain {t_bp:.4f} ms, "
        f"SDPA(dropout_p=0.1) backward {t_bl:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); per launch synced: kernel {t_bs:.4f}, SDPA {t_bls:.4f}")
    shape = ("bh=96 (8 x 12 heads) sq=sk=512 d=dv=64 non-causal bf16 "
             "dropout 0.1, L2 warm; library: scaled_dot_product_attention("
             "dropout_p=0.1), the same work with another mask")
    common = {"route": "cuda", "shape": shape}
    fwd = dict(common, name="flash_fwd_dropout",
               source="flexflow_tpu_torch/csrc/flash_fwd.cu",
               replaces="flexflow_tpu/kernels/attention.py:183",
               max_abs_err=worst["fwd"][0], err_over_limit=worst["fwd"][1],
               tol=TOL["flash_fwd"], ms=t_f, plain_ms=t_fp, bound_ms=f_ms,
               bound_by=f_by, library_ms=t_fl, wmma_ms=t_fw,
               no_dropout_ms=t_f0, ms_per_launch_synced=t_fs,
               library_ms_per_launch_synced=t_fls)
    bwd = dict(common, name="flash_bwd_dropout",
               source="flexflow_tpu_torch/csrc/flash_bwd.cu",
               replaces="flexflow_tpu/kernels/attention.py:233",
               max_abs_err=worst["bwd"][0], err_over_limit=worst["bwd"][2],
               err_over_old_limit=worst["bwd"][1],
               tol="FLASH_BWD_TOL + flash_bwd_slack (16-bit)", ms=t_b,
               plain_ms=t_bp, bound_ms=b_ms, bound_by=b_by, library_ms=t_bl,
               wmma_ms=t_bw, no_dropout_ms=t_b0, ms_per_launch_synced=t_bs,
               library_ms_per_launch_synced=t_bls)
    return [fwd, bwd]


# Paged decode: the serving shape (the serving LM's 8 slots x 16 heads of
# 64, 16-token pages, ragged lengths) and a long shape of the same widths
# whose dense strips (2 x 67 MB) are larger than the 50 MB L2
SERVING_LENGTHS = (1, 17, 100, 256, 300, 511, 512, 512)
LONG_MAX_LEN = 4096
LONG_LENGTHS = (1, 300, 1000, 2048, 2500, 4000, 4096, 4096)
DEAD_PAGE = 2 ** 30   # a table entry past a slot's live pages: never read


def paged_bound(lengths, heads, d, dv, page):
    """bound_ms of one paged-decode call: the live K and V rows (16-bit),
    q read and the output written once, the live table entries and the
    lengths (int32); 4 flops per (live position, head dim)."""
    live = sum(lengths)
    pages = sum(-(-n // page) for n in lengths)
    nbytes = (2 * live * heads * (d + dv) + 2 * len(lengths) * heads * (d + dv)
              + 4 * (pages + len(lengths)))
    return bound_ms(nbytes, live * heads * (2 * d + 2 * dv))


def check_paged(torch, rng_seed=1):
    """Both paged-decode kernels against the plain version (and the dense
    reference, on slots with live positions) at the serving and the long
    shape, on the strided cache view and on a scattered table whose dead
    entries are 2^30, and at the edges (fp16, f32, head dims 8-256, dv !=
    d, pages of 1-16 positions, lengths 0 and past the table); repeats
    bit-equal; both kernels, the plain version and SDPA over the dense
    strips timed with the L2 flushed between calls."""
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.kernels import decode as kd

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    dev, bf16, f16 = "cuda", torch.bfloat16, torch.float16
    h, d, page = HEADS, HIDDEN // HEADS, 16
    worst = {"e": 0.0, "ratio": 0.0}

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def lengths_of(lens):
        return torch.tensor(lens, dtype=torch.int32, device=dev)

    def compare(what, q, kp, vp, table, lengths, path=None, ref_table=None,
                ranks=None):
        path = path or kd.paged_path(q.dtype, q.shape[-1], vp.shape[-1],
                                     kp.stride()[:3] + vp.stride()[:3],
                                     table.shape[1], kp.shape[2])
        before = dict(build.path_counts)
        out = kd._paged_decode_cuda(q, kp, vp, table, lengths, _path=path,
                                    _ranks=ranks)
        plain = kd.paged_decode_plain(q, kp, vp, table, lengths)
        ref = kd.paged_decode_reference(
            q, kp, vp, table if ref_table is None else ref_table, lengths)
        torch.cuda.synchronize()
        what = f"paged {what} {str(q.dtype)[6:]} d={q.shape[-1]} " \
               f"dv={vp.shape[-1]} page={kp.shape[2]} {path}" + (
                   "" if path == "block" else " x" + str(
                       ranks or kd.paged_ranks(table.shape[1], kp.shape[2])))
        expect_path(what, before, "paged_decode", path)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{what}: non-finite")
        e, ratio = check_close(f"{what} vs plain", "paged_decode", out, plain)
        # the dense reference averages V where no position is live; the
        # kernels, the plain version and the TPU kernel give 0 there
        live = lengths > 0
        er, ratio_r = check_close(f"{what} vs reference", "paged_decode",
                                  out[live], ref[live])
        if out[~live].any():
            raise AssertionError(f"{what}: a length-0 slot is not 0")
        worst["e"] = max(worst["e"], e)
        worst["ratio"] = max(worst["ratio"], ratio)
        log(f"  {what}: max|out-plain|={e:.3g} (err/limit {ratio:.3g}) "
            f"max|out-ref|={er:.3g} (err/limit {ratio_r:.3g})")
        return out

    def scattered(d_, dv_, pg, pp, lens, dtype, slots=SLOTS):
        """A contiguous pool behind a scattered table; entries past each
        slot's live pages are DEAD_PAGE in the first table returned, in
        range in the second (for the dense reference)."""
        q = rand(slots, h, d_, dtype=dtype)
        kp = rand(h, slots * pp, pg, d_, dtype=dtype)
        vp = rand(h, slots * pp, pg, dv_, dtype=dtype)
        in_range = torch.randperm(slots * pp, generator=g, device=dev) \
            .view(slots, pp).to(torch.int32)
        table = in_range.clone()
        for b, n in enumerate(lens):
            table[b, -(-min(n, pp * pg) // pg):] = DEAD_PAGE
        return q, kp, vp, table, in_range

    def bit_equal(what, out, args):
        for _ in range(3):
            if not torch.equal(out, kd._paged_decode_cuda(*args)):
                raise AssertionError(f"paged {what}: two runs on the same "
                                     "inputs differ")
        log(f"  paged {what}: 4 runs bit-equal")

    # 1. the serving shape, scattered table with dead entries
    serving = lengths_of(SERVING_LENGTHS)
    pp = MAX_LEN // page
    q, kp, vp, table, in_range = scattered(d, d, page, pp, SERVING_LENGTHS,
                                           bf16)
    compare("serving shape, scattered table", q, kp, vp, table, serving,
            ref_table=in_range)
    # 2. the serving path's pool: a strided view of dense per-slot caches
    kc, vc = rand(SLOTS, MAX_LEN, h, d), rand(SLOTS, MAX_LEN, h, d)
    kv, vv, table = kd.paged_view_of_cache(kc, vc, page)
    sv = (q, kv, vv, table, serving)
    out = compare("serving shape, strided cache view", *sv)
    compare("serving shape, strided cache view", *sv, path="block")
    for ranks in (1, 3, 5):      # other cluster sizes than paged_ranks' 8
        compare("serving shape, strided cache view", *sv, ranks=ranks)
    bit_equal("serving shape", out, sv)
    # 3. the long shape: the same widths, 4096 positions a slot
    long_l = lengths_of(LONG_LENGTHS)
    kcl, vcl = rand(SLOTS, LONG_MAX_LEN, h, d), rand(SLOTS, LONG_MAX_LEN, h, d)
    kvl, vvl, tablel = kd.paged_view_of_cache(kcl, vcl, page)
    lv = (q, kvl, vvl, tablel, long_l)
    out = compare("long shape, strided cache view", *lv)
    compare("long shape, strided cache view", *lv, path="block")
    bit_equal("long shape", out, lv)
    # 4. edges: every dtype and head dim, dv != d, pages of 1 to 16
    # positions; lengths 0, 1, past the table, not a multiple of the page,
    # the whole table, two pages. The cluster kernel's shapes run on both
    # kernels; f32 and head dims not multiples of 8 on the block kernel
    for d_, dv_, pg, dtype in ((64, 64, 16, f16), (128, 128, 16, bf16),
                               (128, 128, 8, f16), (64, 128, 4, bf16),
                               (128, 64, 1, bf16), (256, 256, 16, bf16),
                               (8, 24, 4, f16), (40, 40, 16, bf16),
                               (64, 64, 16, torch.float32),
                               (20, 36, 4, bf16)):
        pp_ = 12
        lens = (0, 1, pp_ * pg + 5, 3 * pg + 1, pp_ * pg, 2 * pg)
        args = scattered(d_, dv_, pg, pp_, lens, dtype, slots=len(lens))
        ln = lengths_of(lens)
        path = kd.paged_path(dtype, d_, dv_,
                             args[1].stride()[:3] + args[2].stride()[:3], pp_,
                             pg)
        for p in sorted({path, "block"}):
            compare("edge", *args[:4], ln, path=p, ref_table=args[4])

    # timings, the L2 flushed before every call
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timings(args, kc_, vc_, lens, max_len, plain_iters):
        """Device ms of both kernels, the plain version (CUDA events around
        each synchronised call: it is host-bound) and SDPA over the dense
        strips (mask built outside the timed span); the cluster and block
        kernels' synced readings; the wrapper's host time a call."""
        def kern(path):
            return lambda: kd._paged_decode_cuda(*args, _path=path)
        q_ = args[0]
        mask = (torch.arange(max_len, device=dev)[None, :]
                < args[4][:, None])[:, None, None, :]
        def lib():
            return sdpa(q_[:, :, None], kc_.transpose(1, 2),
                        vc_.transpose(1, 2), attn_mask=mask)
        ours = kd._paged_decode_cuda(*args)
        lib_err = (lib()[:, :, 0].float() - ours.float()).abs().max().item()
        t = {"ms": time_ms(kern("cluster"), 50, flush),
             "block_ms": time_ms(kern("block"), 50, flush),
             "library_ms": time_ms(lib, 50, flush),
             "plain_ms": time_ms(lambda: kd.paged_decode_plain(*args),
                                 plain_iters, flush, per_launch=True),
             "ms_per_launch_synced": time_ms(kern("cluster"), 50, flush,
                                             per_launch=True),
             "block_ms_per_launch_synced": time_ms(kern("block"), 50, flush,
                                                   per_launch=True),
             "wrapper_host_ms": host_ms(torch, kern("cluster")),
             "library_max_abs_diff": lib_err}
        b_ms, b_by = paged_bound(lens, h, d, d, page)
        t.update(bound_ms=b_ms, bound_by=b_by,
                 ranks=kd.paged_ranks(args[3].shape[1], page),
                 over_bound=t["ms"] / b_ms, block_over_cluster=t["block_ms"]
                 / t["ms"], peak_bandwidth_share=b_ms / t["ms"])
        return t

    ts = timings(sv, kc, vc, SERVING_LENGTHS, MAX_LEN, 3)
    tl = timings(lv, kcl, vcl, LONG_LENGTHS, LONG_MAX_LEN, 2)
    for name, t in (("serving", ts), ("long", tl)):
        log(f"  paged {name} shape (L2 cold): cluster (x{t['ranks']}) "
            f"{t['ms']:.5f} ms, "
            f"block {t['block_ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, "
            f"SDPA {t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}): {t['over_bound']:.2f}x bound, "
            f"{t['peak_bandwidth_share']:.3f} of 3.35 TB/s, block/cluster "
            f"{t['block_over_cluster']:.2f}; synced per launch: cluster "
            f"{t['ms_per_launch_synced']:.4f}, block "
            f"{t['block_ms_per_launch_synced']:.4f}; wrapper host "
            f"{t['wrapper_host_ms']:.4f} ms a call; |SDPA - ours| "
            f"{t['library_max_abs_diff']:.3g}")
    if not (ts["ms"] < ts["block_ms"] and tl["ms"] < tl["block_ms"]):
        log("  paged: the cluster kernel is NOT faster than the block kernel "
            "on both shapes")
    row = {"name": "paged_decode", "route": "cuda",
           "source": "flexflow_tpu_torch/csrc/paged_decode.cu",
           "replaces": "flexflow_tpu/kernels/decode.py:50",
           "max_abs_err": worst["e"], "err_over_limit": worst["ratio"],
           "tol": TOL["paged_decode"], "path": "cluster",
           "bit_equal_runs": 4,
           "shape": ("8 slots x 16 heads, d 64, page 16, lengths "
                     + "/".join(map(str, SERVING_LENGTHS)) + ", strided "
                     "cache view, bf16, L2 cold; library: "
                     "scaled_dot_product_attention over the dense strips "
                     "(all 512 positions, masked)"),
           "long_shape": dict(tl, shape=(
               "8 slots x 16 heads, d 64, page 16, max_len 4096, lengths "
               + "/".join(map(str, LONG_LENGTHS)) + ", strided cache view, "
               "bf16, L2 cold"))}
    row.update(ts)
    return row


def build_model(torch, layers=LAYERS, **cfg):
    """The serving LM (`layers` blocks; `cfg`: further FFConfig fields)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import ActiMode, AggrMode, DataType

    m = FFModel(FFConfig(batch_size=SLOTS, allow_mixed_precision=True, seed=0,
                         **cfg))
    ids = m.create_tensor((SLOTS, MAX_LEN), DataType.DT_INT32)
    t = m.embedding(ids, VOCAB, HIDDEN, AggrMode.AGGR_MODE_NONE)
    for _ in range(layers):
        t = m.multihead_attention(t, t, t, HIDDEN, HEADS, causal=True)
        t = m.dense(t, HIDDEN, ActiMode.AC_MODE_RELU, use_bias=False)
        t = m.dense(t, HIDDEN, use_bias=False)
    m.softmax(m.dense(t, VOCAB))
    m.compile()
    return m


def unit_scale_weights(torch, model, inputs):
    """The models have no residuals or norms, so their glorot draws shrink
    the activations layer by layer until every output row is uniform and
    every check below is vacuous. Rescale, in graph order, each embedding
    table, attention output projection and dense kernel so that its op's
    output has unit standard deviation on `inputs` (data-dependent init in
    the manner of LSUV); an op whose output is all zeros (an expert that
    no token reached) keeps its weights. The weights stay random from the
    seed."""
    from flexflow_tpu_torch.ff_types import OperatorType as T

    ex = model.executor
    which = {T.OP_EMBEDDING: "weight", T.OP_MULTIHEAD_ATTENTION: "wo",
             T.OP_LINEAR: "kernel"}
    inp = {ex.input_pts[0].guid: torch.as_tensor(inputs, device="cuda")}
    with torch.no_grad():
        for op in ex.topo:
            if op.op_type in which:
                out = ex.apply(model.params, inp)[op.outputs[0].guid].float()
                if out.std().item() > 0:
                    model.params[op.name][which[op.op_type]] /= \
                        out.std().item()


def check_cached_vs_forward(torch, model, seqs, plen, max_len=MAX_LEN,
                            per_row=False):
    """The KV-cached path (prefill, then one paged-decode step per token)
    against the full causal forward (the flash kernel) on the same tokens:
    the JAX package's own oracle for its serving. With `per_row` the
    one-token steps pass per-row positions (on the card: the captured
    step's replays). Error metric per position: max over the vocab of
    |p_cached - p_forward|, over the max of p_forward (LOGIT_RTOL says
    why it is not 0)."""
    init, step = model.executor.build_decode(SLOTS, max_len)
    caches = init(model.params)
    n = seqs.shape[1]
    logits, caches = step(model.params, caches, 0, [seqs[:, :plen]])
    cached = [logits[:, -1].float()]
    for t in range(plen, n - 1):
        pos = np.full(SLOTS, t, np.int32) if per_row else t
        logits, caches = step(model.params, caches, pos, [seqs[:, t:t + 1]])
        cached.append(logits[:, 0].float())
    cached = torch.stack(cached, 1)                   # positions plen-1..n-2
    padded = np.zeros((SLOTS, max_len), np.int32)
    padded[:, :n] = seqs
    full = model.executor.build_forward()(model.params, [padded])[
        :, plen - 1:n - 1].float()
    rel = (cached - full).abs().amax(-1) / full.amax(-1)
    err, mean_err = rel.max().item(), rel.mean().item()
    agree = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
    if not (torch.isfinite(cached).all() and torch.isfinite(full).all()):
        raise AssertionError("non-finite logits")
    if err > LOGIT_RTOL:
        raise AssertionError(f"cached logits vs forward: {err} > {LOGIT_RTOL}")
    return err, mean_err, agree


def serve(torch, model):
    """The main path. Returns the serving summary."""
    from flexflow_tpu_torch.runtime.serving import (AdmissionQueue,
                                                    ContinuousBatcher,
                                                    GenerationRequest,
                                                    ServingConfig,
                                                    incremental_generate)

    rng = np.random.RandomState(0)
    summary = {}
    # 1. incremental_generate on a batch of prompts
    plen, new = 64, 32
    prompts = rng.randint(0, VOCAB, (SLOTS, plen)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = incremental_generate(model, prompts, max_new_tokens=new,
                                max_len=MAX_LEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    summary["incremental_generate"] = {
        "batch": SLOTS, "prompt_len": plen, "new_tokens": new,
        "s": dt, "tokens_per_s": SLOTS * new / dt}
    log(f"  incremental_generate: {SLOTS}x{new} tokens in {dt:.3f}s")
    # the one-token steps above replayed the captured decode step; the
    # eager steps must give the same tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = incremental_generate(model, prompts, max_new_tokens=new,
                                 max_len=MAX_LEN, _eager=True)
    torch.cuda.synchronize()
    dt_eager = time.perf_counter() - t0
    if not np.array_equal(eager, toks):
        at = int(np.argmax((eager != toks).any(0)))
        raise AssertionError("captured and eager decode steps disagree "
                             f"from position {at}")
    summary["incremental_generate"].update(
        eager_s=dt_eager, eager_tokens_per_s=SLOTS * new / dt_eager,
        exact_vs_eager=True)
    log(f"  incremental_generate, eager steps: {dt_eager:.3f}s; tokens "
        "equal to the captured steps'")
    # 2. cached logits against the full forward (the flash kernel)
    err, mean_err, agree = check_cached_vs_forward(torch, model, toks, plen)
    summary["cached_vs_forward"] = {"max_rel_err": err,
                                    "mean_rel_err": mean_err,
                                    "tol": LOGIT_RTOL, "argmax_agree": agree}
    log(f"  cached vs forward: max rel err {err:.4g} (tol {LOGIT_RTOL}), "
        f"mean {mean_err:.4g}, argmax agreement {agree:.4f}")
    # 3. a continuous batcher answering ragged requests
    lens = [16, 40, 64, 97, 128, 150, 181, 200, 230, 256]
    reqs_p = [rng.randint(0, VOCAB, n).astype(np.int32) for n in lens]
    q = AdmissionQueue(max_depth=len(lens))
    b = ContinuousBatcher(model, ServingConfig(max_len=MAX_LEN, slots=SLOTS,
                                               page_size=16), q)
    reqs = [GenerationRequest(p, new, deadline_s=600.0) for p in reqs_p]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.start()
    try:
        for r in reqs:
            q.offer(r)
        outs = [r.result(timeout=600) for r in reqs]
    finally:
        b.stop()
    dt = time.perf_counter() - t0
    if b.dead or b.stats["finished"] != len(reqs):
        raise AssertionError(f"batcher: {b.stats}, died: {b.death_cause!r}")
    refs = [incremental_generate(model, p[None], max_new_tokens=new,
                                 max_len=MAX_LEN)[0] for p in reqs_p]
    # the batcher prefills as incremental_generate does (batch 1) and
    # decodes in the running batch through the same kernels: every token
    # must agree
    for i, (o, r) in enumerate(zip(outs, refs)):
        if not np.array_equal(o, r):
            at = int(np.argmax(o != r)) if o.shape == r.shape else -1
            raise AssertionError(
                f"request {i} (prompt {lens[i]}): batcher and "
                f"incremental_generate disagree from position {at}")
    summary["continuous_batcher"] = {
        "requests": len(reqs), "prompt_lens": lens, "new_tokens": new,
        "s": dt, "tokens_per_s": len(reqs) * new / dt,
        "iterations": b.stats["iterations"],
        "exact_vs_incremental_generate": len(reqs),
        "pool_audit_ok": b.pool.audit() == [],
        "pages_in_use_after": b.pool.pages_in_use}
    log(f"  batcher: {len(reqs)} requests x {new} tokens in {dt:.3f}s, "
        f"{len(reqs)}/{len(reqs)} exact vs incremental_generate")
    if b.pool.audit() or b.pool.pages_in_use:
        raise AssertionError(f"page pool not clean: {b.pool.audit()}")
    return summary


def build_transformer_model(torch, spd=1, fusion=False):
    """bench.py's default workload through the port's builder: the
    reference's headline Transformer, bf16 compute over f32 weights;
    `spd` steps a dispatch in fit; `fusion` compiles it with
    perform_fusion (--fusion)."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_transformer

    m = FFModel(FFConfig(batch_size=TRAIN_BATCH, allow_mixed_precision=True,
                         seed=0, iterations_per_dispatch=spd,
                         perform_fusion=fusion))
    build_transformer(m, TRAIN_BATCH, TRAIN_SEQ, HIDDEN, HEADS, LAYERS)
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    return m


def kernel_family(name):
    """The family of a device kernel on the serving and Transformer and
    BERT paths. "cast": dtype conversions (the per-call bf16 copies of f32
    weights among them); "memcpy": host-device copies (the batches)."""
    return ("flash_fwd" if "flash_fwd" in name else
            "flash_bwd" if "flash_bwd" in name else
            "paged_decode" if "paged_decode" in name else
            "gemm" if re.search(r"gemm|gemv|nvjet|xmma|cutlass", name) else
            "cast" if "direct_copy" in name else
            "memcpy" if name.startswith("Memcpy") else
            "other")


KERNEL_FAMILIES = ("flash_fwd", "flash_bwd", "paged_decode", "gemm", "cast",
                   "memcpy", "other")


def _op_kernels(prof, op_family):
    """(family, kernel name, ms) of every kernel whose launching CPU op
    `op_family(chain)` names a family (chain: that op and its ancestors,
    the innermost first, with their recorded input shapes); None leaves
    the op's kernels to their names' families."""
    got = []
    for e in prof.events():
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p)
            p = p.cpu_parent
        fam = op_family(chain)
        if fam is not None:
            got += [(fam, k.name, k.duration / 1e3) for k in e.kernels]
    return got


def profile_step(torch, run, family_of=kernel_family,
                 families=KERNEL_FAMILIES, op_family=None):
    """Device time of one warm call of `run` by kernel family
    (`family_of(kernel name)`), from a torch.profiler trace: the kernels'
    summed durations (one stream, so they do not overlap) against the
    wall time of the call. With `op_family` (see _op_families) the
    kernels of the ops it names form families of their own, taken out of
    their names' families (the trace records input shapes for it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=op_family is not None) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    events = _device_events(torch, prof)
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    family = dict.fromkeys(families, 0.0)
    count = dict.fromkeys(family, 0)
    for name, ms in by_name.items():
        key = family_of(name)
        family[key] += ms
        count[key] += sum(1 for e in events if e.name == name)
    if op_family is not None:
        for fam, name, ms in _op_kernels(prof, op_family):
            # out of the family its name put it in
            family[family_of(name)] -= ms
            count[family_of(name)] -= 1
            family[fam] += ms
            count[fam] += 1
    busy = sum(family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # where the host's time goes: the CPU ops' own time (the profiler
    # slows each op's host side, so read these as shares, not times)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])[:6]
    log(f"  step profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"in {len(events)} device events; "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in family.items()))
    log("  top kernels: " + "; ".join(f"{n[:60]} {ms:.2f} ms"
                                      for n, ms in top[:5]))
    log("  top host ops (self): " + "; ".join(f"{n[:40]} {ms:.2f} ms"
                                              for n, ms in host))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_events": len(events),
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_family_ms": family, "events_by_family": count,
            "memcpy_ms_by_name": {n: ms for n, ms in by_name.items()
                                  if n.startswith("Memcpy")},
            "host_self_ms_top": dict(host),
            "top_kernels_ms": {n[:80]: ms for n, ms in top}}


def _block_of(weight: str) -> int:
    """The encoder block an "op_<type>_<i>.<weight>" name belongs to (each
    block adds three ops: attention, dense, dense)."""
    return int(weight.split(".")[0].rsplit("_", 1)[1]) // 3


def check_training_counts(what, counts, want):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def check_wgmma_paths(what, launches, paths):
    """Every flash launch of a main-path run (`launches`, `paths`: copies
    of build.launch_counts and build.path_counts) took the wgmma kernels."""
    for fam in ("flash_fwd", "flash_bwd"):
        n = launches[fam] + launches[f"{fam}_dropout"]
        want = {f"{fam}_wgmma": n, f"{fam}_wmma": 0, f"{fam}_rows": 0}
        got = {k: paths[k] for k in want}
        if got != want:
            raise AssertionError(f"{what}: flash launches by path {got}, "
                                 f"expected {want}")


def train(torch):
    """The training path. Returns the training summary, with the launch
    counts of the fit run under "launches"."""
    from flexflow_tpu_torch.kernels import build

    model = build_transformer_model(torch)
    rng = np.random.RandomState(0)
    x, y = (rng.randn(TRAIN_BATCH, TRAIN_SEQ, HIDDEN).astype(np.float32)
            for _ in range(2))
    summary = {"model": "transformer", "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "hidden": HIDDEN, "heads": HEADS,
               "blocks": LAYERS, "optimizer": "SGD lr 0.01",
               "loss": "MSE avg", "precision": "bf16 compute and grads, "
               "f32 weights"}
    # 1. fit: TRAIN_STEPS epochs of one batch on the seed's glorot
    # weights, bench.py's own init. (Rescaled to unit activations, as for
    # the oracle below, the net has no norm or residual to bound its
    # curvature and SGD at lr 0.01 diverges within two steps; the glorot
    # draws shrink the activations and keep that lr stable.)
    os.environ.pop("FF_ATTENTION_IMPL", None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.fit(x, y, epochs=TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    paths = dict(build.path_counts)
    text = out.getvalue()
    log("  " + text.strip().replace("\n", "\n  "))
    losses = [float(v) for v in re.findall(r"epoch \d+: loss=(\S+)", text)]
    done = re.search(r"ELAPSED TIME = (\S+)s, THROUGHPUT = (\S+) samples/s",
                     text)
    if len(losses) != TRAIN_STEPS or not done:
        raise AssertionError(f"fit printed {text!r}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit: losses {losses} must be finite and fall")
    per = TRAIN_STEPS * LAYERS
    check_training_counts("fit", counts, {"flash_fwd": per, "flash_bwd": per,
                                          "paged_decode": 0})
    check_wgmma_paths("fit", counts, paths)
    summary.update(steps=TRAIN_STEPS, losses=losses, launches=counts,
                   launches_by_path=paths,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   fit_elapsed_s_reading=float(done.group(1)),
                   fit_samples_per_s_reading=float(done.group(2)))
    # step time on the host clock, warm, the same batch
    step = model.executor.build_train_step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.state, _ = step(model.state, [x], y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    summary["step_ms_reading"] = 1e3 * min(times)
    summary["samples_per_s_reading"] = TRAIN_BATCH / min(times)
    log(f"  fit: losses {losses}; warm step {1e3 * min(times):.2f} ms "
        f"(host clock)")
    summary["step_profile"] = profile_step(torch, lambda: step(model.state,
                                                               [x], y))

    # 2. the gradient oracle, on unit-scaled weights
    unit_scale_weights(torch, model, x)
    grad = model.executor.build_grad_step()
    runs = {}
    for impl in ("flash", "dense"):
        if impl == "dense":
            os.environ["FF_ATTENTION_IMPL"] = "dense"
        torch.cuda.synchronize()
        build.reset_launch_counts()
        runs[impl] = grad(model.params, [x], y)
        torch.cuda.synchronize()
        n = LAYERS if impl == "flash" else 0
        check_training_counts(f"grad step ({impl})", build.launch_counts,
                              {"flash_fwd": n, "flash_bwd": n})
        check_wgmma_paths(f"grad step ({impl})", build.launch_counts,
                          build.path_counts)
    os.environ.pop("FF_ATTENTION_IMPL", None)
    ratios = {}
    for op, gs in runs["dense"].items():
        # per weight, over the norm of the op's whole dense gradient:
        # without residuals, attention averages the tokens until every
        # token entering a deep block is nearly the same bf16 vector, and
        # there dP - delta, and with it the q/k gradients, (nearly) vanish
        # on the dense path while the flash path's delta, taken from its
        # rounded O, leaves a residue of the same tiny size
        op_norm = sum(g.float().norm().item() ** 2 for g in gs.values()) ** 0.5
        if not op_norm > 0:
            raise AssertionError(f"{op}: no dense gradient")
        for name, gd in gs.items():
            gk = runs["flash"][op][name]
            if gk.dtype != torch.bfloat16 or gd.dtype != torch.bfloat16:
                raise AssertionError(f"{op}.{name}: gradients {gk.dtype}, "
                                     f"{gd.dtype}; bf16 expected")
            if not torch.isfinite(gk).all():
                raise AssertionError(f"{op}.{name}: non-finite gradient")
            ratios[f"{op}.{name}"] = (
                (gk.float() - gd.float()).norm().item() / op_norm)
    top = {k: v for k, v in ratios.items() if _block_of(k) == LAYERS - 1}
    worst = max(ratios, key=ratios.get)
    worst_top = max(top, key=top.get)
    med = float(np.median(list(ratios.values())))
    log(f"  gradient oracle: worst ||g_flash - g_dense|| / ||g_dense(op)|| "
        f"{ratios[worst]:.4g} at {worst} (limit {ORACLE_RTOL}); top block "
        f"{top[worst_top]:.4g} at {worst_top} (limit {ORACLE_TOP_RTOL}); "
        f"median {med:.4g} over {len(ratios)} weights")
    log("  " + json.dumps({k: round(v, 6) for k, v in ratios.items()}))
    if ratios[worst] > ORACLE_RTOL or top[worst_top] > ORACLE_TOP_RTOL:
        raise AssertionError(f"gradient oracle: {worst} {ratios[worst]}, "
                             f"top block {worst_top} {top[worst_top]}")
    summary["grad_oracle"] = {
        "worst_rel_err": ratios[worst], "worst_at": worst,
        "limit": ORACLE_RTOL, "top_block_worst_rel_err": top[worst_top],
        "top_block_worst_at": worst_top, "top_block_limit": ORACLE_TOP_RTOL,
        "median_rel_err": med, "weights": len(ratios),
        "launches_flash_run": LAYERS, "launches_dense_run": 0}
    return summary


def build_bert_model(torch, spd=1, optimizer=None):
    """BERT-base as a plain torch.nn.Module (models/bert.py), imported
    through the PyTorch frontend and compiled like the training phase:
    bf16 compute and gradients over f32 weights, MSE-avg, SGD lr 0.01
    (examples/python/bert_proxy.py) unless `optimizer` is given. The
    module's Linear and LayerNorm weights come from torch's seed 0 and
    are carried over with `load_weights`; attention keeps the port's own
    init, as in the JAX frontend."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.frontends.torch import PyTorchModel
    from flexflow_tpu_torch.models import BertEncoder

    torch.manual_seed(0)
    module = BertEncoder(BERT_LAYERS, BERT_HIDDEN, BERT_HEADS, BERT_FFN,
                         BERT_DROPOUT, BERT_DROPOUT)
    m = FFModel(FFConfig(batch_size=BERT_BATCH, allow_mixed_precision=True,
                         seed=0, iterations_per_dispatch=spd))
    x = m.create_tensor((BERT_BATCH, BERT_SEQ, BERT_HIDDEN))
    pt = PyTorchModel(module)
    pt.torch_to_ff(m, [x])
    m.compile(optimizer or SGDOptimizer(lr=0.01),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    pt.load_weights(m)
    return m


def eval_mse(model, x, y):
    """`FFModel.eval`'s MSE metric (dropout off), its printout kept."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pm = model.eval(x, y)
    return pm.mse_loss / max(1, pm.train_rows), out.getvalue().strip()


def bert(torch):
    """The BERT phase: `fit` through the dropout variants of both flash
    kernels, eval before and after, the warm step, a step trace, and the
    gradient oracle (flash vs FF_ATTENTION_IMPL=dense under one step
    seed, so both draw the same masks). Returns the BERT summary, with
    the launch counts of the fit run under "launches"."""
    from flexflow_tpu_torch.core.seeds import step_seed
    from flexflow_tpu_torch.kernels import build

    os.environ.pop("FF_ATTENTION_IMPL", None)
    model = build_bert_model(torch)
    rng = np.random.RandomState(0)
    x, y = (rng.randn(BERT_BATCH, BERT_SEQ, BERT_HIDDEN).astype(np.float32)
            for _ in range(2))
    summary = {"model": "BERT-base encoder via PyTorchModel",
               "source": "google-research/bert uncased_L-12_H-768_A-12/"
                         "bert_config.json",
               "batch": BERT_BATCH, "seq": BERT_SEQ, "hidden": BERT_HIDDEN,
               "heads": BERT_HEADS, "layers": BERT_LAYERS, "ffn": BERT_FFN,
               "dropout": BERT_DROPOUT, "optimizer": "SGD lr 0.01",
               "loss": "MSE avg", "precision": "bf16 compute and grads, "
               "f32 weights"}
    before, _ = eval_mse(model, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.fit(x, y, epochs=BERT_STEPS)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    paths = dict(build.path_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    text = out.getvalue()
    log("  " + text.strip().replace("\n", "\n  "))
    losses = [float(v) for v in re.findall(r"epoch \d+: loss=(\S+)", text)]
    done = re.search(r"ELAPSED TIME = (\S+)s, THROUGHPUT = (\S+) samples/s",
                     text)
    if len(losses) != BERT_STEPS or not done:
        raise AssertionError(f"fit printed {text!r}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"fit: losses {losses} must be finite")
    per = BERT_STEPS * BERT_LAYERS
    check_training_counts("bert fit", counts, {
        "flash_fwd_dropout": per, "flash_bwd_dropout": per, "flash_fwd": 0,
        "flash_bwd": 0, "paged_decode": 0})
    check_wgmma_paths("bert fit", counts, paths)
    after, line = eval_mse(model, x, y)
    log(f"  eval {line}; mse before {before} after {after}")
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"eval mse {before} -> {after}: must fall")
    summary.update(steps=BERT_STEPS, losses=losses, launches=counts,
                   launches_by_path=paths,
                   eval_mse_before=before, eval_mse_after=after,
                   peak_mem_gb=peak,
                   fit_elapsed_s_reading=float(done.group(1)),
                   fit_samples_per_s_reading=float(done.group(2)))
    # the warm step on the host clock, fresh masks each step
    step = model.executor.build_train_step()
    gen = torch.Generator().manual_seed(1)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.state, _ = step(model.state, [x], y, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    summary["step_ms_reading"] = 1e3 * min(times)
    summary["samples_per_s_reading"] = BERT_BATCH / min(times)
    log(f"  fit: losses {losses}; warm step {1e3 * min(times):.2f} ms "
        f"(host clock), {BERT_BATCH / min(times):.2f} samples/s, peak "
        f"{peak:.3f} GiB")
    summary["step_profile"] = profile_step(
        torch, lambda: step(model.state, [x], y, gen))

    # the gradient oracle: one step's gradients under one step seed
    ex = model.executor
    labels = ex._as_labels(y)
    seed = step_seed(torch.Generator().manual_seed(2))
    runs = {}
    for impl in ("flash", "dense"):
        if impl == "dense":
            os.environ["FF_ATTENTION_IMPL"] = "dense"
        torch.cuda.synchronize()
        build.reset_launch_counts()
        runs[impl] = ex._loss_and_grads(model.params, [x], labels, seed)
        torch.cuda.synchronize()
        n = BERT_LAYERS if impl == "flash" else 0
        check_training_counts(f"bert grad step ({impl})", build.launch_counts,
                              {"flash_fwd_dropout": n,
                               "flash_bwd_dropout": n, "flash_fwd": 0,
                               "flash_bwd": 0})
        check_wgmma_paths(f"bert grad step ({impl})", build.launch_counts,
                          build.path_counts)
    os.environ.pop("FF_ATTENTION_IMPL", None)
    loss_f, loss_d = (runs[i][0].item() for i in ("flash", "dense"))
    ratios = {}
    for op, gs in runs["dense"][2].items():
        op_norm = sum(g.float().norm().item() ** 2 for g in gs.values()) ** 0.5
        if not op_norm > 0:
            raise AssertionError(f"{op}: no dense gradient")
        for name, gd in gs.items():
            gk = runs["flash"][2][op][name]
            if not torch.isfinite(gk).all():
                raise AssertionError(f"{op}.{name}: non-finite gradient")
            ratios[f"{op}.{name}"] = (
                (gk.float() - gd.float()).norm().item() / op_norm)
    worst = max(ratios, key=ratios.get)
    mha = {k: v for k, v in ratios.items() if ".w" in k and "attn" in k}
    worst_mha = max(mha, key=mha.get)
    med = float(np.median(list(ratios.values())))
    log(f"  bert gradient oracle: loss flash {loss_f} dense {loss_d}; worst "
        f"{ratios[worst]:.4g} at {worst} (limit {BERT_ORACLE_RTOL}); "
        f"attention weights worst {mha[worst_mha]:.4g} at {worst_mha}; "
        f"median {med:.4g} over {len(ratios)} weights")
    log("  " + json.dumps({k: round(v, 6) for k, v in ratios.items()}))
    if ratios[worst] > BERT_ORACLE_RTOL:
        raise AssertionError(f"bert gradient oracle: {worst} {ratios[worst]}")
    summary["grad_oracle"] = {
        "loss_flash": loss_f, "loss_dense": loss_d,
        "worst_rel_err": ratios[worst], "worst_at": worst,
        "limit": BERT_ORACLE_RTOL, "attention_worst_rel_err": mha[worst_mha],
        "attention_worst_at": worst_mha, "median_rel_err": med,
        "weights": len(ratios), "launches_flash_run": BERT_LAYERS,
        "launches_dense_run": 0}
    return summary


def fit_timed(torch, model, x, y):
    """One quiet `fit` epoch over (x, y) on the host clock (synchronised
    before and after); returns (seconds, its epoch lines without the
    throughput reading, which is a clock)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model.fit(x, y)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lines = [ln.split("throughput")[0] + ln.split("samples/s")[1]
             for ln in out.getvalue().splitlines() if ln.startswith("epoch")]
    return dt, lines


def weight_gap(torch, a, b):
    """How far two models' weights are apart: the weights that differ in
    any bit, and the largest |a - b| over max |a| of a weight."""
    differ, worst, at = 0, 0.0, None
    for op, ws in a.params.items():
        for n, w in ws.items():
            v = b.params[op][n]
            if not torch.equal(w, v):
                differ += 1
                rel = ((w - v).abs().max() / w.abs().max()).item()
                if rel > worst:
                    worst, at = rel, f"{op}.{n}"
    total = sum(len(ws) for ws in a.params.values())
    return {"weights": total, "weights_not_bit_equal": differ,
            "worst_rel_diff": worst, "worst_at": at}


def abba(torch, runs, rounds, samples):
    """Samples/s of the two `runs` (name -> fn returning seconds), taken
    in turns A B B A for `rounds` rounds; per run the median and the
    spread (max - min over the median) of its readings."""
    (na, fa), (nb, fb) = runs.items()
    got = {na: [], nb: []}
    for _ in range(rounds):
        for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
            got[name].append(samples / fn())
    out = {}
    for name, v in got.items():
        med = float(np.median(v))
        out[name] = {"samples_per_s_median": med, "readings": v,
                     "spread": (max(v) - min(v)) / med}
    out["speedup_median"] = (out[nb]["samples_per_s_median"]
                             / out[na]["samples_per_s_median"])
    return out


def weights_finite(torch, model):
    return all(torch.isfinite(w).all().item()
               for ws in model.params.values() for w in ws.values())


def restorer(torch, model):
    """Snapshot the model's training state; returns a function that puts
    it back into the same tensors (the captured graphs keep their
    addresses). The timed turns each start from the snapshot, so each
    trains a finite model: BERT-base diverges under SGD lr 0.01 within
    tens of steps."""
    from flexflow_tpu_torch.parallel.executor import _tensors

    live = _tensors((model.state.params, model.state.opt_state,
                     model.state.net_state))
    saved = [t.clone() for t in live]

    def restore():
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)

    return restore


def timed_turn(torch, model, restore, x, y):
    """One epoch of `fit` from the snapshot, in seconds; raises if the
    weights it leaves are not finite."""
    restore()
    dt = fit_timed(torch, model, x, y)[0]
    if not weights_finite(torch, model):
        raise AssertionError("a timed epoch left non-finite weights")
    return dt


def scan_profile(torch, model, x, y, spd, batch, restore,
                 family_of=kernel_family, families=KERNEL_FAMILIES):
    """One dispatch of the train scan (spd steps: staging, copies and the
    replay), traced; per-step readings beside it. `x` is the input array,
    or the list of a model's input arrays. Every dispatch starts from the
    snapshot `restore` puts back."""
    from flexflow_tpu_torch.core.seeds import step_seed

    scan = model.executor.build_train_scan()
    xs = [v[:spd * batch].reshape((spd, batch) + v.shape[1:])
          for v in (x if isinstance(x, list) else [x])]
    ys = y[:spd * batch].reshape((spd, batch) + y.shape[1:])
    table = model.executor.seed_table(
        [step_seed(model._rng) for _ in range(spd)])

    def run():
        model.state, _ = scan(model.state, xs, ys, table)

    times = []
    for _ in range(4):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    restore()
    prof = profile_step(torch, run, family_of, families)
    if not weights_finite(torch, model):
        raise AssertionError("a traced scan dispatch left non-finite weights")
    # the replay alone between CUDA events: one launch of the whole graph,
    # so its device time (the profiler's per-kernel tracing slows graphs
    # of many small kernels, and its busy time reads high there)
    graph = next(reversed(model.executor._scan_graphs.values())).graph
    replay_ms = []
    for _ in range(3):
        restore()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.graph.replay()
        e1.record()
        e1.synchronize()
        replay_ms.append(e0.elapsed_time(e1))
    restore()
    # the profiler slows the host side (staging, the Python around the
    # replay), so the idle share is also taken against the best
    # unprofiled dispatch
    wall = min(times[1:])
    # what the staged batches cost the card: one dispatch's inputs and
    # labels copied from pinned memory, timed with CUDA events (best of 3)
    src = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
           for a in xs + [ys]]
    dst = [torch.empty_like(a, device="cuda") for a in src]
    copy_ms = []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for d, h in zip(dst, src):
            d.copy_(h, non_blocking=True)
        e1.record()
        e1.synchronize()
        copy_ms.append(e0.elapsed_time(e1))
    nbytes = sum(a.numel() * a.element_size() for a in src)
    del src, dst
    prof.update(steps=spd, dispatch_ms_reading=wall,
                step_ms_reading=wall / spd,
                replay_device_ms_per_step=min(replay_ms) / spd,
                idle_share_replay=max(0.0, 1.0 - min(replay_ms) / wall),
                step_device_busy_ms=prof["device_busy_ms"] / spd,
                idle_share_host_clock=max(
                    0.0, 1.0 - prof["device_busy_ms"] / wall),
                pinned_copy_ms_per_step=min(copy_ms) / spd,
                pinned_copy_gb_per_s=nbytes / min(copy_ms) / 1e6)
    log(f"  scan dispatch of {spd} steps: {prof['step_ms_reading']:.2f} ms "
        f"a step on the host clock, {prof['step_device_busy_ms']:.2f} ms "
        f"device busy, idle share {prof['idle_share_host_clock']:.4f}; the "
        f"replay alone {prof['replay_device_ms_per_step']:.2f} ms a step "
        f"(CUDA events), idle share {prof['idle_share_replay']:.4f} "
        f"(under the profiler {prof['idle_share']:.4f}); batches from "
        f"pinned memory {prof['pinned_copy_ms_per_step']:.3f} ms a step "
        f"({prof['pinned_copy_gb_per_s']:.1f} GB/s); copies in the trace "
        f"{prof['memcpy_ms_by_name']}")
    return prof


def train_scan(torch):
    """The Transformer scan: fit with iterations_per_dispatch SCAN_SPD
    over SCAN_BATCHES batches (two captured chunks and a tail graph of
    one) against stepwise fit from the same weights and data; samples/s
    of both in ABBA turns; one traced scan dispatch."""
    from flexflow_tpu_torch.kernels import build

    rng = np.random.RandomState(5)
    n = SCAN_BATCHES * TRAIN_BATCH
    x, y = (rng.randn(n, TRAIN_SEQ, HIDDEN).astype(np.float32)
            for _ in range(2))
    a = build_transformer_model(torch)
    b = build_transformer_model(torch, spd=SCAN_SPD)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    _, lines_b = fit_timed(torch, b, x, y)
    counts, paths = dict(build.launch_counts), dict(build.path_counts)
    _, lines_a = fit_timed(torch, a, x, y)
    graphs = 1 + int(SCAN_BATCHES % SCAN_SPD != 0)
    want = (SCAN_BATCHES + graphs) * LAYERS
    check_training_counts("transformer scan", counts, {
        "flash_fwd": want, "flash_bwd": want, "paged_decode": 0})
    check_wgmma_paths("transformer scan", counts, paths)
    gap = weight_gap(torch, a, b)
    log(f"  scan vs stepwise fit ({SCAN_BATCHES} batches, "
        f"{SCAN_SPD} a dispatch): epoch lines {lines_b} vs {lines_a}; "
        f"weights {gap}")
    if lines_a != lines_b or gap["weights_not_bit_equal"]:
        raise AssertionError(f"transformer scan vs stepwise: {lines_b} vs "
                             f"{lines_a}, {gap}")
    ra, rb = restorer(torch, a), restorer(torch, b)
    timing = abba(torch, {
        "stepwise": lambda: timed_turn(torch, a, ra, x, y),
        "scan": lambda: timed_turn(torch, b, rb, x, y)}, SCAN_ROUNDS, n)
    log(f"  ABBA x{SCAN_ROUNDS}: stepwise "
        f"{timing['stepwise']['samples_per_s_median']:.2f} samples/s "
        f"(spread {timing['stepwise']['spread']:.3f}), scan "
        f"{timing['scan']['samples_per_s_median']:.2f} "
        f"(spread {timing['scan']['spread']:.3f}), "
        f"x{timing['speedup_median']:.3f}")
    prof = scan_profile(torch, b, x, y, SCAN_SPD, TRAIN_BATCH, rb)
    return {"model": "transformer", "batches": SCAN_BATCHES,
            "iterations_per_dispatch": SCAN_SPD, "graphs": graphs,
            "epoch_lines_equal": True, "weights_vs_stepwise": gap,
            "abba": timing,
            "scan_profile": prof, "launches": counts,
            "launches_by_path": paths}


def remat_check(torch, model, x, y):
    """One step's gradients under one step seed with attention stored
    and recomputed in the backward (remat): equal bit for bit, the same
    dropout masks drawn in both."""
    from flexflow_tpu_torch.core.seeds import step_seed
    from flexflow_tpu_torch.kernels import build

    ex = model.executor
    labels = ex._as_labels(y)
    seed = step_seed(torch.Generator().manual_seed(3))
    runs, peaks, remat_counts = {}, {}, None
    for remat in (False, True):
        ex.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        runs[remat] = ex._loss_and_grads(model.params, [x], labels, seed)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
        if remat:
            remat_counts = dict(build.launch_counts)
    ex.remat = False
    check_training_counts("remat step", remat_counts, {
        "flash_fwd_dropout": 2 * BERT_LAYERS,
        "flash_bwd_dropout": BERT_LAYERS})
    finite = all(torch.isfinite(g).all().item() for r in runs.values()
                 for gs in r[2].values() for g in gs.values())
    differ, worst = 0, 0.0
    for op, gs in runs[False][2].items():
        for name, g in gs.items():
            r = runs[True][2][op][name]
            if not torch.equal(g, r):
                differ += 1
                worst = max(worst, ((g.float() - r.float()).abs().max()
                                    / g.float().abs().max()).item())
    remat = {"gradients": sum(len(g) for g in runs[False][2].values()),
             "not_bit_equal": differ, "worst_rel_diff": worst,
             "finite": finite, "loss_stored": runs[False][0].item(),
             "loss_remat": runs[True][0].item(),
             "peak_gb_stored": peaks[False], "peak_gb_remat": peaks[True],
             "launches": remat_counts}
    log(f"  remat: {remat}")
    if differ or not finite or remat["loss_stored"] != remat["loss_remat"]:
        raise AssertionError(f"remat gradients differ: {remat}")
    return remat


def bert_scan(torch):
    """The BERT scan with dropout: fit with iterations_per_dispatch
    BERT_SCAN_SPD over as many batches (one captured chunk) against
    stepwise fit from the same weights and step seeds; ABBA samples/s; a
    traced dispatch. First, on the fresh weights, the remat check."""
    from flexflow_tpu_torch.kernels import build

    rng = np.random.RandomState(6)
    n = BERT_SCAN_SPD * BERT_BATCH
    x, y = (rng.randn(n, BERT_SEQ, BERT_HIDDEN).astype(np.float32)
            for _ in range(2))
    a = build_bert_model(torch)
    remat = remat_check(torch, a, x[:BERT_BATCH], y[:BERT_BATCH])
    b = build_bert_model(torch, spd=BERT_SCAN_SPD)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    _, lines_b = fit_timed(torch, b, x, y)
    counts, paths = dict(build.launch_counts), dict(build.path_counts)
    _, lines_a = fit_timed(torch, a, x, y)
    want = (BERT_SCAN_SPD + 1) * BERT_LAYERS
    check_training_counts("bert scan", counts, {
        "flash_fwd_dropout": want, "flash_bwd_dropout": want,
        "flash_fwd": 0, "flash_bwd": 0, "paged_decode": 0})
    check_wgmma_paths("bert scan", counts, paths)
    gap = weight_gap(torch, a, b)
    log(f"  bert scan vs stepwise fit ({BERT_SCAN_SPD} steps, dropout "
        f"{BERT_DROPOUT}): epoch lines {lines_b} vs {lines_a}; weights "
        f"{gap}")
    if lines_a != lines_b or gap["weights_not_bit_equal"]:
        raise AssertionError(f"bert scan vs stepwise: {lines_b} vs "
                             f"{lines_a}, {gap}")
    # every timed turn and traced dispatch starts from the weights the
    # equality check left (BERT_SCAN_SPD steps in), and each must leave
    # finite weights
    ra, rb = restorer(torch, a), restorer(torch, b)
    timing = abba(torch, {
        "stepwise": lambda: timed_turn(torch, a, ra, x, y),
        "scan": lambda: timed_turn(torch, b, rb, x, y)}, SCAN_ROUNDS, n)
    log(f"  ABBA x{SCAN_ROUNDS}: stepwise "
        f"{timing['stepwise']['samples_per_s_median']:.2f} samples/s "
        f"(spread {timing['stepwise']['spread']:.3f}), scan "
        f"{timing['scan']['samples_per_s_median']:.2f} "
        f"(spread {timing['scan']['spread']:.3f}), "
        f"x{timing['speedup_median']:.3f}; every turn from the snapshot, "
        f"weights finite after each")
    prof = scan_profile(torch, b, x, y, BERT_SCAN_SPD, BERT_BATCH, rb)
    mask = dropout_mask_timing(torch)
    return {"model": "BERT-base encoder via PyTorchModel",
            "steps": BERT_SCAN_SPD, "iterations_per_dispatch": BERT_SCAN_SPD,
            "dropout": BERT_DROPOUT, "epoch_lines_equal": True,
            "weights_vs_stepwise": gap,
            "abba": timing, "timed_from_snapshot": True,
            "weights_finite_after_every_timed_run": True,
            "scan_profile": prof, "remat": remat, "dropout_mask": mask,
            "launches": counts, "launches_by_path": paths}


def dropout_mask_timing(torch):
    """The standalone Dropout's keep-mask over one BERT activation (batch
    x seq x hidden) under a seed-table entry: the op's int32 form
    (`keep_mask`) against the int64 form of the same hash, which the op
    used before. Bit-equal; each one's device time (profiler) and device
    kernels a call. The least it could take: writing the n-byte mask."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.kernels import attention as ka
    from flexflow_tpu_torch.ops.dropout import keep_mask

    shape = (BERT_BATCH, BERT_SEQ, BERT_HIDDEN)
    n = int(np.prod(shape))
    entry = torch.tensor([ka._i32(v) for v in DROP_SEEDS],
                         dtype=torch.int32, device="cuda")
    thr = ka._drop_threshold(BERT_DROPOUT)

    def int32():
        return keep_mask(entry, BERT_DROPOUT, shape, "cuda")

    def int64():
        s0, s1 = ka._mask_seeds(entry, "cuda")
        idx = torch.arange(n, dtype=torch.int64, device="cuda") & ka._M32
        return (ka._keep_bits(idx, s0, s1) >= thr).view(shape)

    new, old = int32(), int64()
    out = {"shape": list(shape), "bit_equal": bool(torch.equal(new, old)),
           "kept_share": new.float().mean().item(),
           "bound_ms": n / PEAK_BYTES_PER_S * 1e3}
    for name, fn in (("int32", int32), ("int64", int64)):
        out[f"{name}_ms"] = time_ms(fn, 20)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[f"{name}_kernels"] = len(_device_events(torch, prof))
    log(f"  dropout mask {shape}: {out}")
    if not out["bit_equal"]:
        raise AssertionError(f"dropout mask: int32 and int64 differ: {out}")
    return out


# -- the CNN path -----------------------------------------------------------
def cnn_family(name):
    """The family of a device kernel on the CNN path: cuDNN's convolution
    kernels by pass (fprop / dgrad and wgrad), its FFT-based ones (the
    transforms and complex GEMMs, whose name does not tell the pass),
    cuBLAS's GEMMs (the dense layers), pooling, host-device copies, and
    the rest: BatchNorm's and the activations' elementwise and reduction
    kernels, the loss and the optimizer's update (measured on its own,
    `optimizer_profile`)."""
    if re.search(r"dgrad|wgrad|bprop|backward_data|backward_filter|col2im",
                 name, re.I):
        return "conv_bwd"
    if re.search(r"fft|cf32|r2c|c2r", name, re.I):
        return "conv_fft"
    if re.search(r"fprop|convolve|conv2d|winograd|im2col|nchwToNhwc|"
                 r"nhwcToNchw|cudnn", name, re.I):
        return "conv_fwd"
    if re.search(r"gemm|gemv|nvjet|xmma|cutlass", name):
        return "gemm"
    if re.search(r"pool", name, re.I):
        return "pool"
    if name.startswith("Memcpy"):
        return "memcpy"
    return "bn_elementwise"


CNN_FAMILIES = ("conv_fwd", "conv_bwd", "conv_fft", "gemm", "pool",
                "memcpy", "bn_elementwise")


def optimizer_profile(torch, model):
    """Device time of one SGD update of every weight, alone: the same
    kernels on the same shapes as a train step's update, with zero
    gradients (so the weights do not move)."""
    from torch.profiler import ProfilerActivity, profile

    zeros = {op: {n: torch.zeros_like(w) for n, w in ws.items()}
             for op, ws in model.params.items()}
    model.optimizer.update(model.params, zeros, model.state.opt_state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.optimizer.update(model.params, zeros, model.state.opt_state)
        torch.cuda.synchronize()
    events = _device_events(torch, prof)
    return {"ms": sum(e.time_range.elapsed_us() for e in events) / 1e3,
            "events": len(events)}


def cifar_like(seed, n, classes, hw):
    """Synthetic CIFAR-10 as the bootcamp feeds it: n 32x32x3 uint8
    images from `seed`, resized nearest to hw x hw, NCHW, /255; each
    label is the argmax of a fixed random projection of its 32x32 image,
    so the labels are a function of the pixels and the loss can fall."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    proj = rng.randn(3 * 32 * 32, classes)
    y = np.argmax((img.reshape(n, -1) / 255.0 - 0.5) @ proj, axis=1)
    # PIL's NEAREST: source pixel floor((i + 0.5) * 32 / hw)
    idx = np.floor((np.arange(hw) + 0.5) * 32 / hw).astype(np.int64)
    # C order, as the bootcamp's array filled image by image: the fancy
    # indexing leaves other strides, and a strided batch costs the host a
    # slow gather on every copy
    x = np.ascontiguousarray(img[:, :, idx][:, :, :, idx], np.float32) / 255
    return x, y.astype(np.int32).reshape(n, 1)


def build_alexnet_from_file(torch, path, spd=1):
    """The bootcamp flow (bootcamp_demo/ff_alexnet_cifar10.py) on the
    port: replay the `.ff` export into an FFModel, SGD lr 0.01, sparse
    categorical CE with accuracy, f32. Returns (model, input tensor)."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.frontends.torch import PyTorchModel

    m = FFModel(FFConfig(batch_size=ALEX_BATCH, seed=0,
                         iterations_per_dispatch=spd))
    x = m.create_tensor((ALEX_BATCH, 3, ALEX_HW, ALEX_HW))
    PyTorchModel(path).apply(m, [x])
    m.set_sgd_optimizer(SGDOptimizer(lr=0.01))
    m.compile(loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[MetricsType.METRICS_ACCURACY,
                       MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m, x


def fit_lines(torch, model, x, y, epochs):
    """`fit` for `epochs` epochs; returns (its output, the epoch lines
    without their throughput readings, each epoch's mean CE where the
    model reports one)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(out):
        model.fit(x=x, y=y, epochs=epochs)
    torch.cuda.synchronize()
    text = out.getvalue()
    lines = [ln.split("throughput")[0] + ln.split("samples/s")[1]
             for ln in text.splitlines() if ln.startswith("epoch")]
    ce = [float(v) for v in re.findall(r"sparse_cce: (\S+)", text)]
    if len(lines) != epochs or len(ce) not in (0, epochs):
        raise AssertionError(f"fit printed {text!r}")
    return text, lines, ce


def state_gap(torch, a, b):
    """weight_gap over the weights, and the stateful ops' buffers that
    differ in any bit."""
    gap = weight_gap(torch, a, b)
    bufs = [(v, b.state.net_state[op][n])
            for op, vs in a.state.net_state.items() for n, v in vs.items()]
    gap.update(buffers=len(bufs), buffers_not_bit_equal=sum(
        not torch.equal(u, v) for u, v in bufs))
    return gap


def scan_vs_stepwise(torch, what, a, b, xa, ya, xb, yb, epochs):
    """`fit` of the stepwise model `a` and the scan model `b` from the
    same weights and data, the launch counts reset before and read after:
    equal epoch lines, and weights, stateful buffers and optimizer state
    bit for bit. Returns (a's fit output, a's epoch CEs, the gap, peak
    memory of a's fit in GiB, the launch counts of both fits)."""
    from flexflow_tpu_torch.kernels import build

    start = state_gap(torch, a, b)
    if start["weights_not_bit_equal"] or start["buffers_not_bit_equal"]:
        raise AssertionError(f"{what}: the two models start apart {start}")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    text, lines_a, ce = fit_lines(torch, a, xa, ya, epochs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, lines_b, _ = fit_lines(torch, b, xb, yb, epochs)
    counts = dict(build.launch_counts)
    gap = state_gap(torch, a, b)
    gap.update(opt_state_gap(torch, a, b))
    log(f"  {what}: stepwise fit {lines_a}; scan fit {lines_b}; {gap}")
    if (lines_a != lines_b or gap["weights_not_bit_equal"]
            or gap["buffers_not_bit_equal"]
            or gap["opt_buffers_not_bit_equal"]):
        raise AssertionError(f"{what}: scan vs stepwise {lines_b} vs "
                             f"{lines_a}, {gap}")
    log("  " + text.strip().replace("\n", "\n  "))
    return text, ce, gap, peak, counts


def cnn_timing(torch, what, a, b, x, y, n, batch):
    """zoo_timing by CNN kernel family (x, y: arrays or loaders), and the
    optimizer's update alone."""
    out = zoo_timing(torch, what, a, b, [x], y, n, batch, CNN_SPD,
                     family_of=cnn_family, families=CNN_FAMILIES,
                     rounds=CNN_ROUNDS)
    restore = restorer(torch, a)
    opt = optimizer_profile(torch, a)
    restore()
    for p, steps in ((out["step_profile"], 1), (out["scan_profile"],
                                                CNN_SPD)):
        p["optimizer_ms_alone"] = opt["ms"]
        p["bn_elementwise_less_optimizer_ms_a_step"] = (
            p["by_family_ms"]["bn_elementwise"] / steps - opt["ms"])
    log(f"  {what} optimizer update alone: {opt}")
    out["optimizer_profile"] = opt
    return out


def alexnet_oracle(torch, model, x, y):
    """One train step of the port (f32) from the model's weights against
    the same step in float64 on the card through the bootcamp's AlexNet
    module (plain torch: nn.Conv2d and nn.Linear, the same sparse CE on
    the clamped softmax, w -= lr * g). Compared: the loss, and each
    weight's update, ||dW_port - dW_f64|| / ||dW_f64||."""
    from flexflow_tpu_torch.models import AlexNet

    ref = AlexNet(num_classes=ALEX_CLASSES).to("cuda", torch.float64)
    before = {op: {n: w.detach().clone() for n, w in ws.items()}
              for op, ws in model.params.items()}
    mods = {name: mod for name, mod in ref.named_modules()
            if name.replace(".", "_") in before}
    with torch.no_grad():
        for name, mod in mods.items():
            k = before[name.replace(".", "_")]["kernel"].double()
            mod.weight.copy_(k.t() if isinstance(mod, torch.nn.Linear)
                             else k)
            mod.bias.copy_(before[name.replace(".", "_")]["bias"].double())
    probs = ref(torch.as_tensor(x, device="cuda", dtype=torch.float64))
    lab = torch.as_tensor(y, device="cuda", dtype=torch.int64)
    loss = -torch.log(probs.clamp(1e-12, 1.0)).gather(1, lab).mean()
    grads = dict(zip([n for n, _ in ref.named_parameters()],
                     torch.autograd.grad(loss, list(ref.parameters()))))
    model.state, partials = model.executor.build_train_step()(
        model.state, [x], y)
    torch.cuda.synchronize()
    loss_port = float(partials["loss"])
    rel = {}
    for name, mod in mods.items():
        op = name.replace(".", "_")
        for n, pname in (("kernel", "weight"), ("bias", "bias")):
            g = grads[f"{name}.{pname}"]
            if isinstance(mod, torch.nn.Linear) and n == "kernel":
                g = g.t()
            d_ref = -0.01 * g
            d_port = (model.params[op][n] - before[op][n]).double()
            rel[f"{op}.{n}"] = ((d_port - d_ref).norm()
                                / d_ref.norm()).item()
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_port - loss.item()) / loss.item()
    out = {"loss_f32": loss_port, "loss_f64": loss.item(),
           "loss_rel_err": loss_rel, "loss_limit": ALEX_ORACLE_LOSS_RTOL,
           "worst_update_rel_err": rel[worst], "worst_at": worst,
           "update_limit": ALEX_ORACLE_RTOL, "update_rel_err": rel}
    log(f"  oracle (one step, f32 vs f64 on the card): loss {loss_port} vs "
        f"{loss.item()} (rel {loss_rel:.3g}, limit {ALEX_ORACLE_LOSS_RTOL}); "
        f"worst update rel err {rel[worst]:.3g} at {worst} (limit "
        f"{ALEX_ORACLE_RTOL}); {json.dumps(rel)}")
    if loss_rel > ALEX_ORACLE_LOSS_RTOL or rel[worst] > ALEX_ORACLE_RTOL:
        raise AssertionError(f"alexnet oracle: {out}")
    return out


def alexnet(torch):
    """The bootcamp's AlexNet: the port's AlexNet module exported to a
    `.ff` file and replayed, data loaders over synthetic CIFAR-10 at
    229x229, init_layers, fit stepwise and as scans (equal bit for bit),
    the loss falling, ABBA samples/s, traces by kernel family, and the
    float64 oracle. Returns the summary, with the launch counts of the
    two fits under "launches"."""
    import tempfile

    from flexflow_tpu_torch.frontends.torch import torch_to_flexflow
    from flexflow_tpu_torch.models import AlexNet

    n = ALEX_BATCHES * ALEX_BATCH
    x, y = cifar_like(7, n, ALEX_CLASSES, ALEX_HW)
    with tempfile.TemporaryDirectory() as tmp:
        path = torch_to_flexflow(AlexNet(num_classes=ALEX_CLASSES),
                                 os.path.join(tmp, "alexnet.ff"))
        models = [build_alexnet_from_file(torch, path, spd)
                  for spd in (1, CNN_SPD)]
    loaders = []
    for m, t in models:
        loaders.append((m.create_data_loader(t, x),
                        m.create_data_loader(m.get_label_tensor(), y)))
        m.init_layers()
    (a, _), (b, _) = models
    text, ce, gap, peak, counts = scan_vs_stepwise(
        torch, "alexnet", a, b, *loaders[0], *loaders[1], ALEX_EPOCHS)
    done = re.search(r"ELAPSED TIME = (\S+)s, THROUGHPUT = (\S+) samples/s",
                     text)
    if not all(np.isfinite(ce)) or not ce[-1] < ce[0]:
        raise AssertionError(f"alexnet: epoch CE {ce} must be finite and "
                             "fall")
    summary = {
        "model": "AlexNet (bootcamp nn.Module, .ff export replayed)",
        "batch": ALEX_BATCH, "image": [3, ALEX_HW, ALEX_HW],
        "classes": ALEX_CLASSES, "precision": "f32 (cuDNN without TF32)",
        "optimizer": "SGD lr 0.01", "loss": "sparse categorical CE",
        "batches": ALEX_BATCHES, "epochs": ALEX_EPOCHS,
        "iterations_per_dispatch": CNN_SPD, "epoch_ce": ce,
        "scan_vs_stepwise": gap, "peak_mem_gb": peak,
        "fit_elapsed_s_reading": float(done.group(1)),
        "fit_samples_per_s_reading": float(done.group(2)),
        "launches": counts}
    summary.update(cnn_timing(torch, "alexnet", a, b, *loaders[0], n,
                              ALEX_BATCH))
    summary["oracle"] = alexnet_oracle(torch, a, x[:ALEX_BATCH],
                                       y[:ALEX_BATCH])
    return summary


def plain_forward(torch, model, x, dtype):
    """The model's graph recomputed in plain torch at `dtype` in eval
    mode: F.conv2d, F.batch_norm on the running statistics, F.max_pool2d
    and F.avg_pool2d (padding left out of the count), the dense product,
    softmax; the walk follows model.layers, the weights and buffers are
    the model's, cast."""
    import torch.nn.functional as F

    from flexflow_tpu_torch.ff_types import ActiMode
    from flexflow_tpu_torch.ff_types import OperatorType as Op
    from flexflow_tpu_torch.ff_types import PoolType

    env = {model.input_tensors[0].guid: torch.as_tensor(
        x, device="cuda").to(dtype)}
    w = {op: {n: v.to(dtype) for n, v in ws.items()}
         for op, ws in model.params.items()}
    net = {op: {n: v.to(dtype) for n, v in bs.items()}
           for op, bs in model.state.net_state.items()}
    for layer in model.layers:
        ins = [env[t.guid] for t in layer.inputs]
        p, t, lw = layer.params, layer.op_type, w.get(layer.name, {})
        if t == Op.OP_CONV2D:
            y = F.conv2d(ins[0], lw["kernel"], lw.get("bias"),
                         (p.stride_h, p.stride_w),
                         (p.padding_h, p.padding_w), 1, p.groups)
            if p.activation == ActiMode.AC_MODE_RELU:
                y = torch.relu(y)
        elif t == Op.OP_BATCHNORM:
            y = F.batch_norm(ins[0], net[layer.name]["running_mean"],
                             net[layer.name]["running_var"], lw["scale"],
                             lw["bias"], training=False, eps=p.eps)
            if p.relu:
                y = torch.relu(y)
        elif t == Op.OP_POOL2D:
            args = ((p.kernel_h, p.kernel_w), (p.stride_h, p.stride_w),
                    (p.padding_h, p.padding_w))
            y = (F.max_pool2d(ins[0], *args)
                 if p.pool_type == PoolType.POOL_MAX else
                 F.avg_pool2d(ins[0], *args, count_include_pad=False))
        elif t == Op.OP_FLAT:
            y = ins[0].flatten(1)
        elif t == Op.OP_LINEAR:
            y = ins[0] @ lw["kernel"] + lw["bias"]
        elif t == Op.OP_SOFTMAX:
            y = torch.softmax(ins[0], -1)
        elif t == Op.OP_EW_ADD:
            y = ins[0] + ins[1]
        elif t == Op.OP_CONCAT:
            y = torch.cat(ins, dim=p.axis)
        elif t == Op.OP_RELU:
            y = torch.relu(ins[0])
        else:
            raise AssertionError(f"plain_forward: no plain {t.name}")
        env[layer.outputs[0].guid] = y
    return env[model.layers[-1].outputs[0].guid]


def build_resnext_model(torch, spd=1):
    """ResNeXt-50 (models/resnet.py build_resnext50: groups 32, 224x224)
    at scripts/osdi22ae/resnext-50.sh's batch 16, 10 classes, f32, SGD lr
    0.01, sparse categorical CE with accuracy."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_resnext50

    m = FFModel(FFConfig(batch_size=RESNEXT_BATCH, seed=0,
                         iterations_per_dispatch=spd))
    build_resnext50(m, RESNEXT_BATCH, num_classes=ALEX_CLASSES,
                    height=RESNEXT_HW, width=RESNEXT_HW)
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY,
               MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def resnext(torch):
    """ResNeXt-50 with BatchNorm running statistics: stepwise fit against
    fit with iterations_per_dispatch CNN_SPD from the same weights and
    running statistics (weights and buffers bit for bit); eval on the
    running statistics against a float64 recomputation from them; ABBA
    samples/s and traces."""
    n = RESNEXT_BATCHES * RESNEXT_BATCH
    x, y = cifar_like(8, n, ALEX_CLASSES, RESNEXT_HW)
    a, b = build_resnext_model(torch), build_resnext_model(torch, CNN_SPD)
    text, ce, gap, peak, counts = scan_vs_stepwise(
        torch, "resnext-50", a, b, x, y, x, y, 1)
    done = re.search(r"ELAPSED TIME = (\S+)s, THROUGHPUT = (\S+) samples/s",
                     text)
    moved = max((bufs["running_var"] - 1).abs().max().item()
                for bufs in a.state.net_state.values())
    # eval on the running statistics against the same forward in f64
    ev_x, ev_y = x[:RESNEXT_BATCH], y[:RESNEXT_BATCH]
    with contextlib.redirect_stdout(io.StringIO()):
        pm = a.eval(ev_x, ev_y)
    loss_eval = pm.sparse_cce_loss / pm.train_rows
    with torch.no_grad():
        probs = plain_forward(torch, a, ev_x, torch.float64)
        lab = torch.as_tensor(ev_y, device="cuda", dtype=torch.int64)
        loss_ref = (-torch.log(probs.clamp(1e-12, 1.0)).gather(1, lab)
                    .mean().item())
    # the same network on batch statistics, which eval must not read
    _, batch_stats = a.executor.build_eval_step()(a.params, [ev_x], ev_y)
    loss_batch = float(batch_stats["loss"])
    eval_rel = abs(loss_eval - loss_ref) / loss_ref
    log(f"  eval on the running statistics (running_var moved up to "
        f"{moved:.4g} from 1): CE {loss_eval} vs f64 recomputation "
        f"{loss_ref} (rel {eval_rel:.3g}, limit {RESNEXT_EVAL_RTOL}); on "
        f"batch statistics the forward reads {loss_batch}")
    if (not np.isfinite(loss_eval) or eval_rel > RESNEXT_EVAL_RTOL
            or not moved > 0
            or abs(loss_batch - loss_ref) / loss_ref <= RESNEXT_EVAL_RTOL):
        raise AssertionError(f"resnext eval: {loss_eval} vs {loss_ref}, "
                             f"batch statistics {loss_batch}, moved {moved}")
    summary = {
        "model": "ResNeXt-50 (build_resnext50, groups 32)",
        "batch": RESNEXT_BATCH, "image": [3, RESNEXT_HW, RESNEXT_HW],
        "classes": ALEX_CLASSES, "precision": "f32 (cuDNN without TF32)",
        "optimizer": "SGD lr 0.01", "loss": "sparse categorical CE",
        "batches": RESNEXT_BATCHES, "iterations_per_dispatch": CNN_SPD,
        "batchnorms": len(a.state.net_state), "epoch_ce": ce,
        "scan_vs_stepwise": gap, "peak_mem_gb": peak,
        "fit_elapsed_s_reading": float(done.group(1)),
        "fit_samples_per_s_reading": float(done.group(2)),
        "eval": {"ce_running_stats": loss_eval, "ce_f64_recomputed": loss_ref,
                 "rel_err": eval_rel, "limit": RESNEXT_EVAL_RTOL,
                 "ce_batch_stats": loss_batch,
                 "running_var_moved_max": moved},
        "launches": counts}
    summary.update(cnn_timing(torch, "resnext-50", a, b, x, y, n,
                              RESNEXT_BATCH))
    return summary


# -- the rest of the OSDI'22 artifact's models and the MoE Transformer ------
def moe_op_family(chain):
    """The MoE trace's dispatch/combine family, by the op that launched
    a kernel: group_by's and aggregate's matrix products, forward and
    backward (a GEMM with an operand of the mask's experts x capacity
    width). The rest go by kernel name."""
    width = MOE_EXPERTS * moe_capacity()
    op = chain[0]
    if op.name in ("aten::mm", "aten::bmm", "aten::addmm") and any(
            width in (s or ()) for s in (op.input_shapes or ())):
        return "dispatch_combine"
    return None


MOE_FAMILIES = KERNEL_FAMILIES + ("dispatch_combine",)


def moe_capacity():
    from flexflow_tpu_torch.ops.moe import _capacity

    return _capacity(MOE_BATCH * TRAIN_SEQ, MOE_TOPK, MOE_EXPERTS,
                     MOE_CAPACITY)


def build_moe_model(torch, spd=1, mixed=True):
    """The MoE Transformer (models/zoo.py build_moe_transformer) at the
    flagship's width: bench.py's moe leg at batch 8, seq 512, hidden
    1024, 16 heads of 64, 12 layers; 4 experts, top-2, capacity factor
    1.2, lambda_bal 0.04, 10 classes; sparse CE over (8, 512, 1) labels,
    bf16 compute and gradients over f32 weights (f32 throughout with
    `mixed` False), SGD lr 0.01."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_moe_transformer

    m = FFModel(FFConfig(batch_size=MOE_BATCH, seed=0,
                         allow_mixed_precision=mixed,
                         iterations_per_dispatch=spd))
    build_moe_transformer(m, MOE_BATCH, TRAIN_SEQ, HIDDEN, HEADS, MOE_LAYERS,
                          MOE_EXPERTS, MOE_TOPK, MOE_CAPACITY, MOE_LAMBDA,
                          MOE_CLASSES)
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY,
               MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def _act(torch, mode, y):
    from flexflow_tpu_torch.ff_types import ActiMode

    if mode == ActiMode.AC_MODE_RELU:
        return torch.relu(y)
    if mode == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(y)
    if mode != ActiMode.AC_MODE_NONE:
        raise AssertionError(f"plain_graph: no plain {mode}")
    return y


def plain_graph(torch, model, inputs, weights, routing=None):
    """The model's graph recomputed in plain torch in the dtype of
    `weights` ({op: {name: tensor}}, e.g. float64 leaves) and of the
    `inputs` (by the model's input tensors): the dense products and
    embedding bags, concat, reshape, softmax, the LSTM (a step loop of
    its own), attention (scores and probabilities in full, no kernel),
    and the MoE layer as gathers: each
    expert takes its first `capacity` (token, choice) pairs in token
    order, and each token sums its kept choices' outputs weighted by its
    gate (index_select / index_add, not the port's dispatch mask). top_k
    takes the assignments of `routing` ({top_k op name: [b, k] ids}) and
    the gate values at them. Returns (the output, [balance losses])."""
    import torch.nn.functional as F

    from flexflow_tpu_torch.ff_types import AggrMode
    from flexflow_tpu_torch.ff_types import OperatorType as Op

    env = {t.guid: v for t, v in zip(model._fit_input_tensors, inputs)}
    aux = []
    for layer in model.layers:
        ins = [env[t.guid] for t in layer.inputs]
        p, t, w = layer.params, layer.op_type, weights.get(layer.name, {})
        if t == Op.OP_LINEAR:
            y = ins[0] @ w["kernel"]
            if p.use_bias:
                y = y + w["bias"]
            outs = [_act(torch, p.activation, y)]
        elif t == Op.OP_EMBEDDING:
            y = F.embedding(ins[0].long(), w["weight"])
            outs = [y.sum(-2) if p.aggr == AggrMode.AGGR_MODE_SUM else y]
        elif t == Op.OP_CONCAT:
            outs = [torch.cat(ins, dim=p.axis)]
        elif t == Op.OP_RESHAPE:
            outs = [ins[0].reshape(layer.outputs[0].dims)]
        elif t == Op.OP_SOFTMAX:
            outs = [torch.softmax(ins[0], p.dim)]
        elif t == Op.OP_EW_ADD:
            outs = [ins[0] + ins[1]]
        elif t == Op.OP_MULTIHEAD_ATTENTION:
            q, k, v = (torch.einsum("bse,ehd->bshd", x, w[n])
                       for x, n in zip(ins, ("wq", "wk", "wv")))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
            outs = [torch.einsum("bqhd,hde->bqe", o, w["wo"]) + w["bias_o"]]
        elif t == Op.OP_LSTM:
            outs = [_plain_lstm(torch, ins[0], w, p)]
        elif t == Op.OP_TOPK:
            idx = routing[layer.name].long()
            outs = [torch.gather(ins[0], -1, idx), idx]
        elif t == Op.OP_GROUP_BY:
            x, assign = ins
            cap = layer.outputs[0].dims[0]
            outs = []
            for e in range(p.n):
                rows = (assign.reshape(-1) == e).nonzero()[:cap, 0]
                got = x.index_select(0, rows // assign.shape[1])
                outs.append(torch.cat([got, got.new_zeros(
                    cap - len(rows), x.shape[1])]))
        elif t == Op.OP_AGGREGATE:
            gates, assign, experts = ins[0], ins[1], ins[4:]
            b, k = gates.shape
            cap = experts[0].shape[0]
            out = experts[0].new_zeros(b, experts[0].shape[1])
            kept = []
            for e in range(p.n):
                rows = (assign.reshape(-1) == e).nonzero()[:cap, 0]
                g = gates.reshape(-1).index_select(0, rows)
                out = out.index_add(0, rows // k,
                                    g[:, None] * experts[e][:len(rows)])
                kept.append(len(rows))
            if p.lambda_bal > 0:
                f = torch.tensor(kept, dtype=out.dtype,
                                 device=out.device) / (b * k)
                pm = torch.softmax(ins[3], -1).mean(0)
                aux.append(p.lambda_bal * p.n * (f * pm).sum())
            outs = [out]
        else:
            raise AssertionError(f"plain_graph: no plain {t.name}")
        for o, v in zip(layer.outputs, outs):
            env[o.guid] = v
    return env[model.layers[-1].outputs[0].guid], aux


def run_routing(torch, model, xs):
    """The top_k assignments of the model's training forward on `xs` (the
    bf16 run's own routing), by op name, and each MoE layer's share of
    (token, choice) pairs dropped by capacity."""
    from flexflow_tpu_torch.ff_types import OperatorType as Op
    from flexflow_tpu_torch.ops.moe import dropped_share

    ex = model.executor
    with torch.no_grad():
        vals = ex.apply(model.params, ex._input_vals(xs), training=True)
    routing, dropped = {}, {}
    for op in ex.topo:
        if op.op_type == Op.OP_TOPK:
            routing[op.name] = vals[op.outputs[1].guid]
        if op.op_type == Op.OP_GROUP_BY:
            assign = vals[op.inputs[1].guid]
            dropped[op.name] = dropped_share(
                assign, op.params.n, op.outputs[0].material_shape()[0])
    return routing, dropped


def grad_rel_errors(torch, grads, ref):
    """Per weight ||g - g_ref|| over the norm of its op's whole reference
    gradient (as the Transformer's oracle reads it); where the op has no
    reference gradient at all (an expert no kept token reached), ||g||
    itself."""
    rel = {}
    for op, gs in ref.items():
        op_norm = sum(g.norm().item() ** 2 for g in gs.values()) ** 0.5
        for n, g in gs.items():
            got = grads[op][n]
            if not torch.isfinite(got).all():
                raise AssertionError(f"{op}.{n}: non-finite gradient")
            rel[f"{op}.{n}"] = ((got.double() - g).norm().item()
                                / (op_norm if op_norm > 0 else 1.0))
    return rel


def f64_leaves(torch, model):
    return {op: {n: w.detach().double().requires_grad_()
                 for n, w in ws.items()} for op, ws in model.params.items()}


def moe_oracle(torch, model, x, y, loss_rtol, top_rtol, rtol=None):
    """One step's loss and gradients (through the flash kernels) against
    the same step recomputed in float64 on the card (plain_graph), with
    the routing held to the run's own top-k assignments: a bf16 near-tie
    may route otherwise in f64, and that is not a fault. Holds the loss
    to `loss_rtol`, the top layer's weights (the last MoE layer's and the
    classifier's) to `top_rtol` and, given `rtol`, every weight."""
    from flexflow_tpu_torch.kernels import build

    routing, dropped = run_routing(torch, model, [x])
    torch.cuda.synchronize()
    build.reset_launch_counts()
    loss, _, grads = model.executor._loss_and_grads(
        model.params, [x], model.executor._as_labels(y), None)
    torch.cuda.synchronize()
    check_training_counts("moe oracle step", build.launch_counts, {
        "flash_fwd": MOE_LAYERS, "flash_bwd": MOE_LAYERS})
    if model.executor.compute_dtype is not None:
        check_wgmma_paths("moe oracle step", build.launch_counts,
                          build.path_counts)
    leaves = f64_leaves(torch, model)
    xd = torch.as_tensor(x, device="cuda", dtype=torch.float64)
    probs, aux = plain_graph(torch, model, [xd], leaves, routing)
    lab = torch.as_tensor(y, device="cuda", dtype=torch.int64)
    ce = -torch.log(probs.clamp(1e-12, 1.0)).gather(-1, lab).mean()
    ref_loss = ce + sum(aux)
    flat = [(op, n, w) for op, ws in leaves.items() for n, w in ws.items()]
    gs = torch.autograd.grad(ref_loss, [w for _, _, w in flat])
    ref = {}
    for (op, n, _), g in zip(flat, gs):
        ref.setdefault(op, {})[n] = g
    rel = grad_rel_errors(torch, grads, ref)
    worst = max(rel, key=rel.get)
    # ops are numbered in build order, MOE_OPS_A_LAYER to a layer
    top = {k: v for k, v in rel.items() if int(k.split(".")[0].rsplit(
        "_", 1)[1]) >= (MOE_LAYERS - 1) * MOE_OPS_A_LAYER}
    worst_top = max(top, key=top.get)
    loss_rel = abs(loss.item() - ref_loss.item()) / ref_loss.item()
    dtype = str(model.executor.compute_dtype or torch.float32)[6:]
    out = {"compute": dtype, "loss": loss.item(),
           "loss_f64": ref_loss.item(), "aux_f64": float(sum(aux).detach()),
           "loss_rel_err": loss_rel, "loss_limit": loss_rtol,
           "worst_rel_err": rel[worst], "worst_at": worst, "limit": rtol,
           "top_layer_worst_rel_err": top[worst_top],
           "top_layer_worst_at": worst_top, "top_layer_limit": top_rtol,
           "median_rel_err": float(np.median(list(rel.values()))),
           "weights": len(rel), "dropped_share_by_layer": dropped,
           "rel_err": rel}
    log(f"  oracle, {dtype} (routing fixed to the run's top-k): loss "
        f"{loss.item()} vs f64 {ref_loss.item()} (rel {loss_rel:.3g}, "
        f"limit {loss_rtol}); worst ||g - g64|| / ||g64(op)|| "
        f"{rel[worst]:.4g} at {worst} (limit {rtol}), top layer "
        f"{top[worst_top]:.4g} at {worst_top} (limit {top_rtol}), median "
        f"{out['median_rel_err']:.4g} over {len(rel)} weights")
    log("  " + json.dumps({k: round(v, 6) for k, v in rel.items()}))
    if (loss_rel > loss_rtol or top[worst_top] > top_rtol
            or (rtol is not None and rel[worst] > rtol)):
        raise AssertionError(f"moe oracle: {out}")
    return out


def aux_reaches_gate(torch, model, x):
    """The balance losses of one training forward (nonzero) and the
    norm of their gradient with respect to each gate's kernel: nonzero
    (the loss reaches the gate) wherever the gate is live, i.e. some
    token's RELU gate is positive. A dead gate (every gate value 0: every
    choice a tie, broken toward experts 0 and 1) passes no gradient, in
    JAX as here."""
    from flexflow_tpu_torch.ff_types import OperatorType as Op

    ex = model.executor
    topk = [op for op in ex.topo if op.op_type == Op.OP_TOPK]
    gates = [op.inputs[0].owner_op.name for op in topk]
    leaves = {op: {n: w.detach().requires_grad_() for n, w in ws.items()}
              for op, ws in model.params.items()}
    aux = []
    with torch.enable_grad():
        vals = ex.apply(leaves, ex._input_vals([x]), training=True,
                        aux_out=aux)
        gs = torch.autograd.grad(sum(aux), [leaves[g]["kernel"]
                                            for g in gates])
    live = {g: bool((vals[op.inputs[0].guid] > 0).any())
            for g, op in zip(gates, topk)}
    out = {"aux_losses": [a.item() for a in aux],
           "gate_grad_norms": {g: v.float().norm().item()
                               for g, v in zip(gates, gs)},
           "live_gates": live}
    log(f"  balance losses {out['aux_losses']}; their gradients' norms at "
        f"the gates {out['gate_grad_norms']}; live gates {live}")
    if len(aux) != MOE_LAYERS or not all(a > 0 for a in out["aux_losses"]) \
            or not any(live.values()) or not all(
                v > 0 for g, v in out["gate_grad_norms"].items()
                if live[g]):
        raise AssertionError(f"moe: the balance loss does not reach the "
                             f"gates: {out}")
    return out


def zoo_timing(torch, what, a, b, xs, y, n, batch, spd, op_family=None,
               family_of=kernel_family, families=KERNEL_FAMILIES,
               rounds=ZOO_ROUNDS):
    """ABBA samples/s of one epoch of stepwise and scan `fit` from a
    snapshot (xs: the input arrays or loaders, y the labels'); a
    stepwise step traced by family (`op_family`: see profile_step); one
    scan dispatch traced."""
    ra, rb = restorer(torch, a), restorer(torch, b)
    timing = abba(torch, {
        "stepwise": lambda: timed_turn(torch, a, ra, xs, y),
        "scan": lambda: timed_turn(torch, b, rb, xs, y)}, rounds, n)
    log(f"  {what} ABBA x{rounds}: stepwise "
        f"{timing['stepwise']['samples_per_s_median']:.2f} samples/s "
        f"(spread {timing['stepwise']['spread']:.3f}), scan "
        f"{timing['scan']['samples_per_s_median']:.2f} "
        f"(spread {timing['scan']['spread']:.3f}), "
        f"x{timing['speedup_median']:.3f}")
    arrays = [getattr(v, "full_array", v) for v in xs]
    ys = getattr(y, "full_array", y)
    step = a.executor.build_train_step()
    bx = [v[:batch] for v in arrays]
    ra()
    step(a.state, bx, ys[:batch])  # warm
    ra()
    prof = profile_step(torch, lambda: step(a.state, bx, ys[:batch]),
                        family_of, families, op_family)
    ra()
    sprof = scan_profile(torch, b, arrays, ys, spd, batch, rb, family_of,
                         families)
    ra()
    return {"abba": timing, "step_profile": prof, "scan_profile": sprof}


def opt_state_gap(torch, a, b):
    """The optimizer buffers (momentum) that differ in any bit."""
    from flexflow_tpu_torch.parallel.executor import _tensors

    ta, tb = _tensors(a.state.opt_state), _tensors(b.state.opt_state)
    return {"opt_buffers": len(ta), "opt_buffers_not_bit_equal": sum(
        not torch.equal(u, v) for u, v in zip(ta, tb))}


def fit_readings(text):
    done = re.search(r"ELAPSED TIME = (\S+)s, THROUGHPUT = (\S+) samples/s",
                     text)
    losses = [float(v) for v in re.findall(r"epoch \d+: loss=(\S+)", text)]
    if not done or not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"fit printed {text!r}")
    return {"losses": losses, "fit_elapsed_s_reading": float(done.group(1)),
            "fit_samples_per_s_reading": float(done.group(2))}


def moe(torch):
    """The MoE Transformer: stepwise fit against fit with
    iterations_per_dispatch MOE_SPD from the same weights (bit-equal),
    the flash kernels on the wgmma path, the balance loss reaching the
    gates, the capacity's dropped share, the fixed-routing float64
    oracle, ABBA samples/s and a traced step with the dispatch/combine
    products as a family."""
    from flexflow_tpu_torch.kernels import build

    n = MOE_BATCHES * MOE_BATCH
    rng = np.random.RandomState(11)
    x = rng.randn(n, TRAIN_SEQ, HIDDEN).astype(np.float32)
    y = rng.randint(0, MOE_CLASSES, (n, TRAIN_SEQ, 1)).astype(np.int32)
    a, b = build_moe_model(torch), build_moe_model(torch, MOE_SPD)
    text, _, gap, peak, counts = scan_vs_stepwise(
        torch, "moe transformer", a, b, [x], y, [x], y, 1)
    paths = dict(build.path_counts)
    want = (MOE_BATCHES + MOE_BATCHES + 1) * MOE_LAYERS
    check_training_counts("moe fits", counts, {
        "flash_fwd": want, "flash_bwd": want, "paged_decode": 0})
    check_wgmma_paths("moe fits", counts, paths)
    summary = {
        "model": "MoE Transformer (build_moe_transformer)",
        "batch": MOE_BATCH, "seq": TRAIN_SEQ, "hidden": HIDDEN,
        "heads": HEADS, "layers": MOE_LAYERS, "experts": MOE_EXPERTS,
        "top_k": MOE_TOPK, "capacity_factor": MOE_CAPACITY,
        "capacity": moe_capacity(), "lambda_bal": MOE_LAMBDA,
        "classes": MOE_CLASSES, "precision": "bf16 compute and grads, "
        "f32 weights", "optimizer": "SGD lr 0.01",
        "loss": "sparse categorical CE + balance losses",
        "batches": MOE_BATCHES, "iterations_per_dispatch": MOE_SPD,
        "weights": sum(w.numel() for ws in a.params.values()
                       for w in ws.values()),
        "scan_vs_stepwise": gap, "peak_mem_gb": peak, "launches": counts,
        "launches_by_path": paths}
    summary.update(fit_readings(text))
    summary["balance_glorot"] = aux_reaches_gate(torch, a, x[:MOE_BATCH])
    summary["dropped_share_glorot"] = run_routing(torch, a,
                                                  [x[:MOE_BATCH]])[1]
    log(f"  dropped by capacity ({moe_capacity()} slots an expert), the "
        f"trained glorot weights: {summary['dropped_share_glorot']}")
    summary.update(zoo_timing(torch, "moe", a, b, [x], y, n, MOE_BATCH,
                              MOE_SPD, moe_op_family,
                              families=MOE_FAMILIES))
    # the checks below on weights rescaled to unit activations (as the
    # Transformer's oracle): at glorot scale the tokens collapse with
    # depth and the deep layers' RELU gates die (every gate 0)
    unit_scale_weights(torch, a, x[:MOE_BATCH])
    summary["balance"] = aux_reaches_gate(torch, a, x[:MOE_BATCH])
    if not all(summary["balance"]["live_gates"].values()):
        raise AssertionError("moe: a gate is dead on the rescaled weights")
    summary["oracle"] = moe_oracle(
        torch, a, x[:MOE_BATCH], y[:MOE_BATCH], MOE_ORACLE_LOSS_RTOL,
        MOE_ORACLE_TOP_RTOL)
    summary["dropped_share_by_layer"] = summary["oracle"].pop(
        "dropped_share_by_layer")
    log(f"  dropped by capacity, rescaled weights: "
        f"{summary['dropped_share_by_layer']}")
    del a, b
    torch.cuda.empty_cache()
    # the same oracle in f32 (the f32 flash path): rounding no longer
    # compounds through the 12 layers, so every weight is held
    m = build_moe_model(torch, mixed=False)
    unit_scale_weights(torch, m, x[:MOE_BATCH])
    summary["oracle_f32"] = moe_oracle(
        torch, m, x[:MOE_BATCH], y[:MOE_BATCH], MOE_F32_LOSS_RTOL,
        MOE_F32_RTOL, MOE_F32_RTOL)
    summary["oracle_f32"].pop("dropped_share_by_layer")
    return summary


def dlrm_op_family(chain):
    """The embedding bags' forward gather and backward (the dense table
    gradient) as a family of their own."""
    if any(e.name in ("aten::embedding", "aten::embedding_backward",
                      "aten::embedding_dense_backward") for e in chain):
        return "embedding"
    return None


DLRM_FAMILIES = KERNEL_FAMILIES + ("embedding",)


def build_zoo_model(torch, builder, batch, spd=1, loss="sparse", lr=0.01,
                    momentum=0.0, **kw):
    """A zoo model (models/*.py) at `batch`, f32, SGD, sparse CE with
    accuracy or MSE."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType

    m = FFModel(FFConfig(batch_size=batch, seed=0,
                         iterations_per_dispatch=spd))
    builder(m, batch, **kw)
    if loss == "sparse":
        lt = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
        ms = [MetricsType.METRICS_ACCURACY,
              MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY]
    else:
        lt = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
        ms = [MetricsType.METRICS_MEAN_SQUARED_ERROR]
    m.compile(SGDOptimizer(lr=lr, momentum=momentum), lt, ms)
    return m


def zoo_data(model, n, seed, vocab):
    """n synthetic samples from `seed`: ids below `vocab` for the int
    inputs, normal features, labels over the output's classes (or normal
    targets for a regressor)."""
    rng = np.random.RandomState(seed)
    xs = []
    for t in model._fit_input_tensors:
        shape = (n,) + t.dims[1:]
        if t.data_type.name == "DT_INT32":
            xs.append(rng.randint(0, vocab, shape).astype(np.int32))
        else:
            xs.append(rng.randn(*shape).astype(np.float32))
    lab = model.get_label_tensor()
    if lab.data_type.name == "DT_INT32":
        classes = model.executor.logits_pt.material_shape()[-1]
        y = rng.randint(0, classes, (n,) + lab.dims[1:]).astype(np.int32)
    else:
        y = rng.randn(n, *lab.dims[1:]).astype(np.float32)
    return xs, y


def grad_oracle(torch, what, model, xs, y, loss_kind, rtol, loss_rtol):
    """One f32 train step's loss and gradients (the executor's
    `_loss_and_grads`, what the step applies) from the model's weights
    against the same step in float64 on the card (plain_graph): per
    weight ||g - g64|| / ||g64||. (The update itself, w_after - w_before,
    cannot be read closer than an f32 step of the weight, which at lr
    0.01 is ~1e-3 of the update.)"""
    leaves = f64_leaves(torch, model)
    ins = [torch.as_tensor(v, device="cuda") for v in xs]
    ins = [v.double() if v.is_floating_point() else v for v in ins]
    out, _ = plain_graph(torch, model, ins, leaves)
    if loss_kind == "sparse":
        lab = torch.as_tensor(y, device="cuda", dtype=torch.int64)
        loss = -torch.log(out.clamp(1e-12, 1.0)).gather(-1, lab).mean()
    else:
        d = out - torch.as_tensor(y, device="cuda", dtype=torch.float64)
        loss = (d * d).sum(-1).mean()
    flat = [(op, n, w) for op, ws in leaves.items() for n, w in ws.items()]
    gs = torch.autograd.grad(loss, [w for _, _, w in flat])
    ex = model.executor
    loss_port, _, grads = ex._loss_and_grads(model.params, xs,
                                             ex._as_labels(y), None)
    torch.cuda.synchronize()
    rel = {}
    for (op, n, _), g in zip(flat, gs):
        rel[f"{op}.{n}"] = ((grads[op][n].double() - g).norm().item()
                            / g.norm().item())
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_port.item() - loss.item()) / abs(loss.item())
    res = {"loss_f32": loss_port.item(), "loss_f64": loss.item(),
           "loss_rel_err": loss_rel, "loss_limit": loss_rtol,
           "worst_grad_rel_err": rel[worst], "worst_at": worst,
           "grad_limit": rtol, "grad_rel_err": rel}
    log(f"  {what} oracle (one step, f32 vs f64 on the card): loss "
        f"{loss_port.item()} vs {loss.item()} (rel {loss_rel:.3g}, limit "
        f"{loss_rtol}); worst gradient rel err {rel[worst]:.3g} at {worst} "
        f"(limit {rtol})")
    if loss_rel > loss_rtol or rel[worst] > rtol:
        raise AssertionError(f"{what} oracle: {res}")
    return res


def dlrm(torch):
    """DLRM at dlrm.cc's defaults (4 tables of 1M x 64 summed over bags of
    one id, bottom MLP 4-64-64, top 64-64-2 with a sigmoid, cat), batch
    64, sparse CE with accuracy, SGD lr 0.01, f32: stepwise fit against
    the scan (tables and MLP weights bit-equal), accuracy from fit, one
    step against float64, ABBA samples/s, a traced step with the
    embedding bags as a family."""
    from flexflow_tpu_torch.models import build_dlrm

    n = DLRM_BATCHES * DLRM_BATCH
    a, b = (build_zoo_model(torch, build_dlrm, DLRM_BATCH, spd)
            for spd in (1, ZOO_SPD))
    xs, y = zoo_data(a, n, 12, DLRM_ROWS)
    text, _, gap, peak, counts = scan_vs_stepwise(torch, "dlrm", a, b, xs, y,
                                                  xs, y, 1)
    summary = {"model": "DLRM (build_dlrm defaults)", "batch": DLRM_BATCH,
               "tables": [DLRM_ROWS] * 4, "precision": "f32",
               "optimizer": "SGD lr 0.01", "loss": "sparse categorical CE",
               "batches": DLRM_BATCHES, "iterations_per_dispatch": ZOO_SPD,
               "weights": sum(w.numel() for ws in a.params.values()
                              for w in ws.values()),
               "scan_vs_stepwise": gap, "peak_mem_gb": peak,
               "launches": counts,
               "accuracy_partials": {"correct": a.perf_metrics.train_correct,
                                     "all": a.perf_metrics.train_all}}
    summary.update(fit_readings(text))
    log(f"  dlrm accuracy from fit: {summary['accuracy_partials']}")
    summary.update(zoo_timing(torch, "dlrm", a, b, xs, y, n, DLRM_BATCH,
                              ZOO_SPD, dlrm_op_family,
                              families=DLRM_FAMILIES))
    summary["oracle"] = grad_oracle(
        torch, "dlrm", a, [v[:DLRM_BATCH] for v in xs], y[:DLRM_BATCH],
        "sparse", ZOO_ORACLE_RTOL, ZOO_ORACLE_LOSS_RTOL)
    return summary


def inception(torch):
    """Inception-v3 (build_inception_v3, 3x299x299, 1000 classes) at
    examples/python/inception.py's batch 64 and SGD lr 0.01 momentum 0.9,
    sparse CE with accuracy, f32: stepwise fit against the scan (weights,
    momentum and every BatchNorm's running statistics bit-equal), eval on
    the running statistics against a float64 recomputation, ABBA
    samples/s and traces by CNN family."""
    from flexflow_tpu_torch.models import build_inception_v3

    n = INCEPTION_BATCHES * INCEPTION_BATCH
    a, b = (build_zoo_model(torch, build_inception_v3, INCEPTION_BATCH, spd,
                            momentum=0.9, num_classes=INCEPTION_CLASSES,
                            height=INCEPTION_HW, width=INCEPTION_HW)
            for spd in (1, CNN_SPD))
    x, y = cifar_like(13, n, INCEPTION_CLASSES, INCEPTION_HW)
    text, _, gap, peak, counts = scan_vs_stepwise(
        torch, "inception-v3", a, b, [x], y, [x], y, 1)
    ev_x, ev_y = x[:INCEPTION_BATCH], y[:INCEPTION_BATCH]
    with contextlib.redirect_stdout(io.StringIO()):
        pm = a.eval(ev_x, ev_y)
    loss_eval = pm.sparse_cce_loss / pm.train_rows
    with torch.no_grad():
        probs = plain_forward(torch, a, ev_x, torch.float64)
        lab = torch.as_tensor(ev_y, device="cuda", dtype=torch.int64)
        loss_ref = (-torch.log(probs.clamp(1e-12, 1.0)).gather(1, lab)
                    .mean().item())
    eval_rel = abs(loss_eval - loss_ref) / loss_ref
    log(f"  eval on the running statistics: CE {loss_eval} vs f64 "
        f"recomputation {loss_ref} (rel {eval_rel:.3g}, limit "
        f"{RESNEXT_EVAL_RTOL})")
    if not np.isfinite(loss_eval) or eval_rel > RESNEXT_EVAL_RTOL:
        raise AssertionError(f"inception eval: {loss_eval} vs {loss_ref}")
    summary = {"model": "Inception-v3 (build_inception_v3)",
               "batch": INCEPTION_BATCH,
               "image": [3, INCEPTION_HW, INCEPTION_HW],
               "classes": INCEPTION_CLASSES,
               "precision": "f32 (cuDNN without TF32)",
               "optimizer": "SGD lr 0.01 momentum 0.9",
               "loss": "sparse categorical CE",
               "batches": INCEPTION_BATCHES,
               "iterations_per_dispatch": CNN_SPD,
               "batchnorms": len(a.state.net_state),
               "weights": sum(w.numel() for ws in a.params.values()
                              for w in ws.values()),
               "scan_vs_stepwise": gap, "peak_mem_gb": peak,
               "launches": counts,
               "eval": {"ce_running_stats": loss_eval,
                        "ce_f64_recomputed": loss_ref, "rel_err": eval_rel,
                        "limit": RESNEXT_EVAL_RTOL}}
    summary.update(fit_readings(text))
    summary.update(cnn_timing(torch, "inception-v3", a, b, x, y, n,
                              INCEPTION_BATCH))
    return summary


def zoo(torch):
    """CANDLE-Uno, MLP_Unify and XDL at their examples' sizes and batch
    64: stepwise fit against the scan (bit-equal), the loss finite,
    samples/s and peak memory."""
    from flexflow_tpu_torch.models import (build_candle_uno,
                                           build_mlp_unify, build_xdl)

    cases = {
        # examples/python/candle_uno.py: SGD lr 0.001, MSE
        "candle_uno": (build_candle_uno, dict(
            loss="mse", lr=0.001, feature_shapes=(942, 5270, 2048)), 1),
        # examples/python/mlp_unify.py: the builder's defaults
        "mlp_unify": (build_mlp_unify, {}, 1),
        # examples/python/xdl.py: 4 tables of 100000 ids
        "xdl": (build_xdl, dict(embedding_sizes=(XDL_ROWS,) * 4), XDL_ROWS),
    }
    out, counts = {}, {}
    n = ZOO_BATCHES * ZOO_BATCH
    for name, (builder, kw, vocab) in cases.items():
        a, b = (build_zoo_model(torch, builder, ZOO_BATCH, spd, **kw)
                for spd in (1, ZOO_SPD))
        xs, y = zoo_data(a, n, 14, vocab)
        text, _, gap, peak, c = scan_vs_stepwise(torch, name, a, b, xs, y,
                                                 xs, y, 1)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        s = {"batch": ZOO_BATCH, "scan_vs_stepwise": gap,
             "peak_mem_gb": peak,
             "weights": sum(w.numel() for ws in a.params.values()
                            for w in ws.values())}
        s.update(fit_readings(text))
        s.update(zoo_timing(torch, name, a, b, xs, y, n, ZOO_BATCH,
                            ZOO_SPD))
        out[name] = s
        del a, b
        torch.cuda.empty_cache()
    out["launches"] = counts
    return out


def check_flash_long(torch):
    """Both flash kernels at the long-context model's attention shape
    (bh 32 = 4 x 8 heads, 32768 x 32768, d 64, non-causal, bf16): the
    forward against chunked_attention on the same values in f32 (no_grad;
    dense f32 would need 137 GB of scores), the backward with dO live on
    LC_BWD_BLOCKS blocks of queries (scaled by LC_DO_SCALE) against the
    plain backward over those rows under the derived 16-bit limit, each
    output also by the norm of its error under FLASH_NORM_TOL, with
    planted faults shown to fail that; and both timed beside SDPA at the
    same shape, chunked_attention (the streaming plain version) and their
    bounds, which are by operations here."""
    from flexflow_tpu_torch.kernels import attention as ka
    from flexflow_tpu_torch.kernels import build

    g = torch.Generator(device="cuda").manual_seed(21)
    bh, s, d = LC_BATCH * LC_HEADS, LC_SEQ, LC_HIDDEN // LC_HEADS
    q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    what = f"flash bh={bh} sq=sk={s} d=dv={d} non-causal bf16"
    norm_tol = ka.FLASH_NORM_TOL[torch.bfloat16]
    norms, planted = {}, {}

    def hold_norm(name, got, ref):
        norms[name] = ka.rel_norm_err(got, ref)
        if not norms[name] <= norm_tol:
            raise AssertionError(f"{what} {name}: ||err||/||ref|| "
                                 f"{norms[name]} over {norm_tol}")

    def plant(name, got, ref):
        planted[name] = ka.rel_norm_err(got, ref)
        if not planted[name] > norm_tol:
            raise AssertionError(f"{what}: planted fault {name} reads "
                                 f"{planted[name]}, under the norm limit "
                                 f"{norm_tol}: the check cannot see it")

    before = dict(build.path_counts)
    o, lse = ka._flash_fwd_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    expect_path(what, before, "flash_fwd", "wgmma")
    with torch.no_grad():
        ref = ka.chunked_attention(*(ka._fold_to_bhsd(x.float(), LC_BATCH,
                                                      LC_HEADS)
                                     for x in (q, k, v)))
        ref = ka._bhsd_to_fold(ref)
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{what}: non-finite")
    eo, ratio = check_close(f"{what} vs chunked", "flash_fwd", o, ref)
    hold_norm("o", o, ref)
    tile = LC_BWD_ROWS
    bad, _ = ka._flash_fwd_cuda(q, k[:, tile:].contiguous(),
                                v[:, tile:].contiguous(), causal=False)
    plant("o without keys 0..127", bad, ref)
    # what the per-element limit makes of that fault
    atol, rtol = TOL["flash_fwd"]
    bad_ratio = ((bad.float() - ref.float()).abs()
                 / (atol + rtol * ref.float().abs())).max().item()
    del ref, bad
    log(f"  {what}: max|O-chunked f32|={eo:.3g} (err/limit {ratio:.3g}), "
        f"||err||/||O|| {norms['o']:.3g} (limit {norm_tol:.3g})")
    # the backward on LC_BWD_BLOCKS blocks of live dO
    starts = [int(i * (s - LC_BWD_ROWS) / (LC_BWD_BLOCKS - 1))
              for i in range(LC_BWD_BLOCKS)]
    rows = torch.cat([torch.arange(r, r + LC_BWD_ROWS, device="cuda")
                      for r in starts])
    do = torch.zeros_like(o)
    do[:, rows] = (LC_DO_SCALE * torch.randn(
        bh, len(rows), d, generator=g, device="cuda")).to(torch.bfloat16)
    before = dict(build.path_counts)
    dq, dk, dv = ka._flash_bwd_cuda(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    expect_path(f"{what} backward", before, "flash_bwd", "wgmma")
    dead = torch.ones(s, dtype=torch.bool, device="cuda")
    dead[rows] = False
    if dq[:, dead].any():
        raise AssertionError(f"{what} backward: dq is not 0 where dO is")
    ins = (q[:, rows].contiguous(), k, v, o[:, rows].contiguous(),
           lse[:, :, rows].contiguous(), do[:, rows].contiguous())
    ref = ka.flash_bwd_plain(*ins, causal=False)
    slack = ka.flash_bwd_slack(*ins, causal=False)
    got = (dq[:, rows], dk, dv)
    eb, r_old, r_new = check_bwd_close(f"{what} backward", got, ref, slack,
                                       torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        hold_norm(name, a, b)
    plant("dv * 1.5", dv * 1.5, ref[2])
    dk_bad = dk.clone()
    dk_bad[:, :tile] = 0
    plant("dk with keys 0..127 zeroed", dk_bad, ref[1])
    scale = {n: x.float().abs().mean().item()
             for n, x in zip(("dq", "dk", "dv"), ref)}
    del ref, slack, ins, got, dk_bad
    log(f"  {what} backward ({LC_BWD_BLOCKS} blocks of {LC_BWD_ROWS} live "
        f"rows, dO x{LC_DO_SCALE:g}; mean |dq| {scale['dq']:.3g}, |dk| "
        f"{scale['dk']:.3g}, |dv| {scale['dv']:.3g}): max|grad-plain| "
        f"{eb:.3g}, err/limit {r_new:.3g} (old limit {r_old:.3g}); "
        f"||err||/||ref|| dq {norms['dq']:.3g} dk {norms['dk']:.3g} dv "
        f"{norms['dv']:.3g}")
    log(f"  {what}: planted faults' ||err||/||ref|| " + ", ".join(
        f"{n} {x:.3g}" for n, x in planted.items())
        + f"; the dropped tile's per-element err/limit {bad_ratio:.3g}")
    # timing, with dO live everywhere, by CUDA events around each call: a
    # call takes 5-800 ms here, so the host's ~0.1 ms a call is under 2%,
    # and a profiler trace of calls this long has come back with kernels
    # missing (a backward that read below its bound)
    do = torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
    t_f = time_ms(lambda: ka._flash_fwd_cuda(q, k, v, causal=False), 10,
                  per_launch=True)
    t_b = time_ms(lambda: ka._flash_bwd_cuda(q, k, v, o, lse, do,
                                             causal=False), 5,
                  per_launch=True)
    q4, k4, v4 = (x.view(LC_BATCH, LC_HEADS, s, d).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lf = time_ms(lambda: sdpa(q4, k4, v4), 10, per_launch=True)
    out = sdpa(q4, k4, v4)
    do4 = do.view(LC_BATCH, LC_HEADS, s, d)
    t_lb = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                               retain_graph=True), 5,
                   per_launch=True)
    del out
    with torch.no_grad():
        qs, ks, vs = (ka._fold_to_bhsd(x.float(), LC_BATCH, LC_HEADS)
                      for x in (q, k, v))
        t_c = time_ms(lambda: ka.chunked_attention(qs, ks, vs), 2,
                      per_launch=True)
    del qs, ks, vs
    fb, ff_by = bound_ms(2 * 4 * bh * s * d + 4 * bh * s,
                         bh * s * s * (2 * d + 2 * d))
    bb, bb_by = bound_ms(2 * 8 * bh * s * d + 4 * bh * s,
                         5 * 2 * bh * s * s * d)
    for what_t, t, bound in (("forward", t_f, fb), ("SDPA", t_lf, fb),
                             ("backward", t_b, bb),
                             ("SDPA backward", t_lb, bb)):
        if not t >= bound:
            raise AssertionError(f"{what} {what_t}: {t} ms reads below its "
                                 f"bound {bound} ms: the timing is wrong")
    log(f"  {what}: forward {t_f:.3f} ms (bound {fb:.3f} ms, {ff_by}; "
        f"x{t_f / fb:.2f}), SDPA {t_lf:.3f} ms, chunked f32 {t_c:.3f} ms; "
        f"backward {t_b:.3f} ms (bound {bb:.3f} ms, {bb_by}; "
        f"x{t_b / bb:.2f}), SDPA backward {t_lb:.3f} ms")
    shape = f"bh={bh} sq=sk={s} d=dv={d} non-causal bf16"
    return {"flash_fwd": {
        "shape": shape, "ms": t_f, "bound_ms": fb, "bound_by": ff_by,
        "library_ms": t_lf, "over_bound": t_f / fb,
        "over_library": t_f / t_lf, "chunked_f32_ms": t_c,
        "plain_ms": "not run: dense f32 scores would take 137 GB",
        "max_abs_err_vs_chunked": eo, "err_over_limit": ratio,
        "tol": TOL["flash_fwd"], "rel_norm_err": norms["o"],
        "norm_tol": norm_tol, "planted_faults_rel_norm": planted,
        "dropped_tile_err_over_limit": bad_ratio},
        "flash_bwd": {
        "shape": shape, "ms": t_b, "bound_ms": bb, "bound_by": bb_by,
        "library_ms": t_lb, "over_bound": t_b / bb,
        "over_library": t_b / t_lb,
        "plain_ms": "not run: dense f32 scores would take 137 GB",
        "checked_rows": f"{LC_BWD_BLOCKS} blocks of {LC_BWD_ROWS} queries "
                        f"at {starts}, dO 0 elsewhere",
        "do_scale": LC_DO_SCALE, "mean_abs_ref": scale,
        "max_abs_err": eb, "err_over_limit": r_new,
        "err_over_old_limit": r_old,
        "tol": "FLASH_BWD_TOL + flash_bwd_slack",
        "rel_norm_err": {n: norms[n] for n in ("dq", "dk", "dv")},
        "norm_tol": norm_tol}}


def build_lc_model(torch, spd=1, seq=LC_SEQ):
    """build_long_context_transformer at its defaults (or `seq`
    positions), bf16 over f32, sparse CE, SGD lr 0.01."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType
    from flexflow_tpu_torch.models import build_long_context_transformer

    m = FFModel(FFConfig(batch_size=LC_BATCH, allow_mixed_precision=True,
                         seed=0, iterations_per_dispatch=spd))
    build_long_context_transformer(m, LC_BATCH, seq, LC_HIDDEN, LC_HEADS,
                                   LC_LAYERS, LC_CLASSES)
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


def lc_data(n, seq, seed):
    """n samples of normal tokens and skewed labels (class c with weight
    1/(c+1)), made in bulk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, seq, LC_HIDDEN), dtype=np.float32)
    p = 1.0 / np.arange(1, LC_CLASSES + 1)
    y = rng.choice(LC_CLASSES, size=(n, seq, 1), p=p / p.sum())
    return x, y.astype(np.int32)


def lc_oracle(torch, x, y):
    """One bf16 train step of the long-context model at LC_ORACLE_SEQ
    positions through the flash kernels against the same step in f32 with
    dense attention (plain_graph), per weight over its op's f32 gradient
    norm."""
    from flexflow_tpu_torch.kernels import build

    model = build_lc_model(torch, seq=LC_ORACLE_SEQ)
    leaves = {op: {n: w.detach().float().requires_grad_()
                   for n, w in ws.items()} for op, ws in model.params.items()}
    out, _ = plain_graph(torch, model, [torch.as_tensor(x, device="cuda")],
                         leaves)
    lab = torch.as_tensor(y, device="cuda", dtype=torch.int64)
    loss = -torch.log(out.clamp(1e-12, 1.0)).gather(-1, lab).mean()
    flat = [(op, n, w) for op, ws in leaves.items() for n, w in ws.items()]
    gs = torch.autograd.grad(loss, [w for _, _, w in flat])
    ref = {}
    for (op, n, _), g in zip(flat, gs):
        ref.setdefault(op, {})[n] = g
    del out, gs
    ex = model.executor
    build.reset_launch_counts()
    loss_port, _, grads = ex._loss_and_grads(model.params, [x],
                                             ex._as_labels(y), None)
    torch.cuda.synchronize()
    check_training_counts("longctx oracle step", build.launch_counts, {
        "flash_fwd": LC_LAYERS, "flash_bwd": LC_LAYERS})
    check_wgmma_paths("longctx oracle step", build.launch_counts,
                      build.path_counts)
    rel = grad_rel_errors(torch, grads, ref)
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_port.item() - loss.item()) / abs(loss.item())
    res = {"seq": LC_ORACLE_SEQ, "loss_bf16": loss_port.item(),
           "loss_f32": loss.item(), "loss_rel_err": loss_rel,
           "loss_limit": LC_ORACLE_LOSS_RTOL,
           "worst_grad_rel_err": rel[worst], "worst_at": worst,
           "median_grad_rel_err": float(np.median(list(rel.values()))),
           "grad_limit": LC_ORACLE_RTOL, "grad_rel_err": rel}
    log(f"  longctx oracle at {LC_ORACLE_SEQ} positions (one bf16 step "
        f"through the flash kernels vs f32 dense): loss {loss_port.item()} "
        f"vs {loss.item()} (rel {loss_rel:.3g}, limit "
        f"{LC_ORACLE_LOSS_RTOL}); worst gradient {rel[worst]:.4g} at "
        f"{worst} (limit {LC_ORACLE_RTOL}), median "
        f"{res['median_grad_rel_err']:.4g}")
    if loss_rel > LC_ORACLE_LOSS_RTOL or rel[worst] > LC_ORACLE_RTOL:
        raise AssertionError(f"longctx oracle: {res}")
    return res


def longctx(torch):
    """The long-context Transformer at 32768 positions: both flash kernels
    at its attention shape against chunked_attention and the plain
    backward; stepwise fit against the scan (bit-equal; every flash
    launch on wgmma); the loss on one batch falling over LC_STEPS steps;
    ABBA samples/s, a traced step and scan dispatch, peak memory; and the
    gradient oracle at LC_ORACLE_SEQ positions."""
    from flexflow_tpu_torch.kernels import build

    kernels = check_flash_long(torch)
    torch.cuda.empty_cache()
    n = LC_BATCHES * LC_BATCH
    x, y = lc_data(n, LC_SEQ, 31)
    a, b = build_lc_model(torch), build_lc_model(torch, LC_SPD)
    text, _, gap, peak, counts = scan_vs_stepwise(
        torch, "longctx", a, b, [x], y, [x], y, 1)
    paths = dict(build.path_counts)
    want = (LC_BATCHES + LC_BATCHES + 1) * LC_LAYERS
    check_training_counts("longctx fits", counts, {
        "flash_fwd": want, "flash_bwd": want, "paged_decode": 0})
    check_wgmma_paths("longctx fits", counts, paths)
    summary = {
        "model": "build_long_context_transformer (its defaults)",
        "batch": LC_BATCH, "seq": LC_SEQ, "hidden": LC_HIDDEN,
        "heads": LC_HEADS, "layers": LC_LAYERS, "classes": LC_CLASSES,
        "precision": "bf16 compute and grads, f32 weights",
        "optimizer": "SGD lr 0.01", "loss": "sparse categorical CE",
        "labels": "class c with weight 1/(c+1)", "batches": LC_BATCHES,
        "iterations_per_dispatch": LC_SPD,
        "weights": sum(w.numel() for ws in a.params.values()
                       for w in ws.values()),
        "scan_vs_stepwise": gap, "peak_mem_gb": peak, "launches": counts,
        "launches_by_path": paths, "flash_long_shape": kernels}
    summary.update(fit_readings(text))
    summary.update(zoo_timing(torch, "longctx", a, b, [x], y, n, LC_BATCH,
                              LC_SPD, rounds=LC_ROUNDS))
    # the loss on one batch over LC_STEPS steps
    step = a.executor.build_train_step()
    bx, by = [x[:LC_BATCH]], y[:LC_BATCH]
    losses = []
    for _ in range(LC_STEPS):
        a.state, parts = step(a.state, bx, by)
        losses.append(float(parts["loss"]))
    log(f"  longctx losses on one batch over {LC_STEPS} steps: {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"longctx: losses {losses} must be finite and "
                             "fall")
    summary["losses_one_batch"] = losses
    del a, b, x, y
    torch.cuda.empty_cache()
    xo, yo = lc_data(LC_BATCH, LC_ORACLE_SEQ, 32)
    summary["oracle"] = lc_oracle(torch, xo, yo)
    return summary


def _plain_lstm(torch, x, w, p):
    """An LSTM in plain torch in x's dtype: gates i, f, g, o of
    x_t Wx + h Wh + b, c and h carried in that dtype."""
    b, steps, _ = x.shape
    h = x.new_zeros(b, p.hidden_size)
    c = x.new_zeros(b, p.hidden_size)
    hs = []
    for t in range(steps):
        z = x[:, t] @ w["wx"] + h @ w["wh"] + w["bias"]
        i, f, gg, o = (z[:, j * p.hidden_size:(j + 1) * p.hidden_size]
                       for j in range(4))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1) if p.return_sequences else hs[-1]


def build_nmt_model(torch, spd=1):
    """build_nmt as examples/python/nmt.py -b 32 runs it, the config made
    through FFConfig.parse_args."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_nmt

    cfg = FFConfig(seed=0, iterations_per_dispatch=spd)
    cfg.parse_args(["-b", str(NMT_BATCH)])
    if cfg.batch_size != NMT_BATCH:
        raise AssertionError(f"parse_args -b: batch {cfg.batch_size}")
    m = FFModel(cfg)
    build_nmt(m, cfg.batch_size, src_vocab=NMT_VOCAB, tgt_vocab=NMT_VOCAB,
              src_len=NMT_LEN, tgt_len=NMT_LEN)
    m.compile(SGDOptimizer(lr=0.1),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def nmt(torch):
    """NMT (5 LSTMs x 32 steps, vocabulary 8000): stepwise fit against the
    scan over NMT_EPOCHS epochs (bit-equal), the epoch CE falling, ABBA
    samples/s with the stepwise step's idle share, and one f32 step's
    gradients against float64."""
    n = 4 * NMT_BATCH                    # nmt.py's dataset
    a, b = build_nmt_model(torch), build_nmt_model(torch, NMT_SPD)
    rng = np.random.RandomState(0)       # nmt.py's data
    xs = [rng.randint(0, NMT_VOCAB, (n, NMT_LEN)).astype(np.int32)
          for _ in range(2)]
    y = rng.randint(0, NMT_VOCAB, (n, NMT_LEN, 1)).astype(np.int32)
    text, ce, gap, peak, counts = scan_vs_stepwise(
        torch, "nmt", a, b, xs, y, xs, y, NMT_EPOCHS)
    if not all(np.isfinite(ce)) or not ce[-1] < ce[0]:
        raise AssertionError(f"nmt: epoch CE {ce} must be finite and fall")
    summary = {"model": "build_nmt (examples/python/nmt.py -b 32)",
               "batch": NMT_BATCH, "vocab": NMT_VOCAB, "src_len": NMT_LEN,
               "tgt_len": NMT_LEN, "embed": 256, "hidden": 512, "layers": 2,
               "precision": "f32", "optimizer": "SGD lr 0.1",
               "loss": "sparse categorical CE", "samples": n,
               "epochs": NMT_EPOCHS, "iterations_per_dispatch": NMT_SPD,
               "weights": sum(w.numel() for ws in a.params.values()
                              for w in ws.values()),
               "epoch_ce": ce, "scan_vs_stepwise": gap, "peak_mem_gb": peak,
               "launches": counts}
    summary.update(fit_readings(text))
    summary.update(zoo_timing(torch, "nmt", a, b, xs, y, n, NMT_BATCH,
                              NMT_SPD))
    summary["oracle"] = grad_oracle(
        torch, "nmt", a, [v[:NMT_BATCH] for v in xs], y[:NMT_BATCH],
        "sparse", NMT_ORACLE_RTOL, NMT_ORACLE_LOSS_RTOL)
    return summary


def fused_gap(torch, fused, unfused):
    """weight_gap of a fused model against an unfused one, each fused
    step's weights read under its chain op's name."""
    differ, total = 0, 0
    for op in fused.executor.topo:
        chain = getattr(op, "fused_from", None)
        for n, w in fused.params.get(op.name, {}).items():
            if chain is None:
                v = unfused.params[op.name][n]
            else:
                step, name = n.split("/", 1)
                v = unfused.params[chain[int(step[4:])]][name]
            total += 1
            differ += not torch.equal(w, v)
    return {"weights": total, "weights_not_bit_equal": differ}


def fusion(torch):
    """--fusion on the flagship Transformer: the fused PCG (its OP_FUSED
    nodes counted), `fit` of the fused model stepwise and as scans of
    SCAN_SPD against the unfused model's stepwise fit from the same
    weights (epoch lines and weights bit for bit), and ABBA samples/s of
    the unfused against the fused model."""
    from flexflow_tpu_torch.ff_types import OperatorType
    from flexflow_tpu_torch.kernels import build

    u = build_transformer_model(torch)
    f1, fs = (build_transformer_model(torch, spd, fusion=True)
              for spd in (1, SCAN_SPD))
    n_fused = sum(op.op_type == OperatorType.OP_FUSED for op in f1.graph.ops)
    if n_fused != LAYERS or len(f1.graph.ops) != 2 * LAYERS:
        raise AssertionError(f"fusion: {n_fused} fused ops in "
                             f"{len(f1.graph.ops)}, expected {LAYERS} of "
                             f"{2 * LAYERS}")
    for m in (f1, fs):
        start = fused_gap(torch, m, u)
        if start["weights_not_bit_equal"]:
            raise AssertionError(f"fusion: the models start apart {start}")
    n = FUSION_BATCHES * TRAIN_BATCH
    rng = np.random.RandomState(41)
    x, y = (rng.randn(n, TRAIN_SEQ, HIDDEN).astype(np.float32)
            for _ in range(2))
    torch.cuda.synchronize()
    build.reset_launch_counts()
    _, lines_u, _ = fit_lines(torch, u, x, y, 1)
    counts_u = dict(build.launch_counts)
    build.reset_launch_counts()
    _, lines_f, _ = fit_lines(torch, f1, x, y, 1)
    _, lines_s, _ = fit_lines(torch, fs, x, y, 1)
    counts = dict(build.launch_counts)
    paths = dict(build.path_counts)
    gaps = {"stepwise": fused_gap(torch, f1, u),
            "scan": fused_gap(torch, fs, u)}
    log(f"  fusion: unfused {lines_u}; fused {lines_f}; fused scan "
        f"{lines_s}; {gaps}")
    if (lines_f != lines_u or lines_s != lines_u
            or any(g["weights_not_bit_equal"] for g in gaps.values())):
        raise AssertionError(f"fusion: fused vs unfused {lines_f} "
                             f"{lines_s} vs {lines_u}, {gaps}")
    # the fused fits launch the kernels the unfused fit does: stepwise
    # FUSION_BATCHES steps, the scan as many plus one warm-up step
    want = (2 * FUSION_BATCHES + 1) * LAYERS
    check_training_counts("fused fits", counts, {
        "flash_fwd": want, "flash_bwd": want, "paged_decode": 0})
    check_wgmma_paths("fused fits", counts, paths)
    if counts_u["flash_fwd"] != FUSION_BATCHES * LAYERS:
        raise AssertionError(f"unfused fit: {counts_u}")
    ru, rf = restorer(torch, u), restorer(torch, f1)
    timing = abba(torch, {
        "unfused": lambda: timed_turn(torch, u, ru, x, y),
        "fused": lambda: timed_turn(torch, f1, rf, x, y)}, FUSION_ROUNDS, n)
    log(f"  fusion ABBA x{FUSION_ROUNDS}: unfused "
        f"{timing['unfused']['samples_per_s_median']:.2f} samples/s, fused "
        f"{timing['fused']['samples_per_s_median']:.2f} "
        f"(x{timing['speedup_median']:.4f})")
    return {"model": "flagship Transformer (bench.py's default leg), "
                     "perform_fusion", "fused_ops": n_fused,
            "pcg_ops": len(f1.graph.ops), "unfused_pcg_ops": len(u.graph.ops),
            "batches": FUSION_BATCHES, "iterations_per_dispatch": SCAN_SPD,
            "epoch_lines": lines_u, "fused_vs_unfused": gaps,
            "launches": counts, "launches_unfused": counts_u,
            "abba": timing}


# The search phase: the flagship searched with search_budget 10 in the
# measured mode, for 1 worker and for 8 simulated H100 workers; each
# winner trains SEARCH_STEPS steps beside an unsearched compile on the
# same batches. A measured time may sit at its roofline bound but not
# below: SEARCH_BOUND_FLOOR leaves room for the events' microsecond
# resolution and for a clock above base.
SEARCH_BUDGET, SEARCH_WORKERS, SEARCH_STEPS = 10, 8, 4
SEARCH_BOUND_FLOOR = 0.9
# a winner whose compute ops differ from the lowering's (a merge
# rewrite) starts from other weights: its losses are held to the
# unsearched model's within this relative limit instead of bit for bit
SEARCH_LOSS_RTOL = 0.05


def measured_flops(rec):
    """Forward FLOPs of one shard the measurer timed (search/measure.py
    Measurement), from the shapes it ran: a Linear's product, or an
    attention op's projections, scores, weighted sum and output
    projection."""
    if rec.op_type == "OP_LINEAR":
        return 2.0 * float(np.prod(rec.shard_shapes[0])) * \
            rec.weight_shapes[0][-1]
    if rec.op_type == "OP_MULTIHEAD_ATTENTION":
        (b, sq, e), (_, sk, _), _ = rec.shard_shapes
        _, h, d = rec.weight_shapes[0]
        dv, out = rec.weight_shapes[3][1], rec.weight_shapes[3][2]
        return (2.0 * b * sq * e * h * d * 3 + 2.0 * b * h * sq * sk * d
                + 2.0 * b * h * sq * sk * dv + 2.0 * b * sq * h * dv * out)
    raise AssertionError(f"no FLOP count for {rec.op_type}")


def measured_bounds(rec):
    """(forward, forward with backward) least times in seconds of what
    one measurement's calls moved and computed on an H100: the bytes the
    forward call read and wrote (and the gradients the other call wrote
    besides) over the HBM rate, and the forward's FLOPs (three times
    them with the backward: dgrad and wgrad, or attention's four
    products against two) over the bf16 peak; times the shards a device
    runs."""
    flops = measured_flops(rec)
    fwd = max(rec.fwd_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S)
    total = max((rec.fwd_bytes + rec.grad_bytes) / PEAK_BYTES_PER_S,
                3 * flops / PEAK_BF16_FLOP_PER_S)
    return fwd * rec.shards_per_device, total * rec.shards_per_device


def build_searched_model(torch, workers, export=""):
    """The flagship as the training phase builds it, compiled with the
    Unity search in the measured mode for `workers` H100s (the default
    machine, search/machine_model.py h100_machine)."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.ff_types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_transformer

    m = FFModel(FFConfig(batch_size=TRAIN_BATCH, allow_mixed_precision=True,
                         seed=0, search_budget=SEARCH_BUDGET,
                         measure_operator_costs=True,
                         search_num_workers=workers,
                         export_strategy_file=export))
    build_transformer(m, TRAIN_BATCH, TRAIN_SEQ, HIDDEN, HEADS, LAYERS)
    t0 = time.perf_counter()
    m.compile(SGDOptimizer(lr=0.01),
              LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              [MetricsType.METRICS_MEAN_SQUARED_ERROR])
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def search_run(torch, workers, export=""):
    """One measured search: its host seconds, what it measured (each
    measurement held to its bound), each op type's measured times beside
    the analytic model's and the bound, the winner, and the flash
    launches the measurement made by path."""
    from flexflow_tpu_torch.kernels import build

    build.reset_launch_counts()
    model, secs = build_searched_model(torch, workers, export)
    counts, paths = dict(build.launch_counts), dict(build.path_counts)
    phases = dict(model.compile_phase_s)
    meas = model.measurer
    table = model.searched_op_costs
    # every compute op of the winner priced from a finite measurement
    bad = [e["name"] for e in table
           if not (e["measured"] and e["measurement"] is not None
                   and np.isfinite(e["fwd_s"]) and np.isfinite(e["bwd_s"]))]
    if not table or bad:
        raise AssertionError(f"search x{workers}: ops of the winner not "
                             f"measured: {bad or 'no ops'}")
    below = []
    for rec in meas.measurements.values():
        fb, tb = measured_bounds(rec)
        if not (np.isfinite(rec.fwd_s) and np.isfinite(rec.total_s)):
            below.append((rec.op_type, "not finite"))
        if rec.fwd_s < SEARCH_BOUND_FLOOR * fb \
                or rec.total_s < SEARCH_BOUND_FLOOR * tb:
            below.append((rec.op_type, rec.shard_shapes, rec.fwd_s, fb,
                          rec.total_s, tb))
    if below:
        raise AssertionError(f"search x{workers}: measured below "
                             f"{SEARCH_BOUND_FLOOR} x bound: {below}")
    if not (paths["flash_fwd_wgmma"] and paths["flash_bwd_wgmma"]):
        raise AssertionError(f"search x{workers}: the measurement launched "
                             f"no flash forward and backward on wgmma: "
                             f"{paths}")
    check_wgmma_paths(f"search x{workers}", counts, paths)
    by_type = {}
    for e in table:
        if e["op_type"] in by_type:
            continue
        rec = e["measurement"]
        fb, tb = measured_bounds(rec)
        by_type[e["op_type"]] = {
            "shard_shapes": rec.shard_shapes, "view": e["view"],
            "measured_fwd_ms": 1e3 * e["fwd_s"],
            "measured_bwd_ms": 1e3 * e["bwd_s"],
            "analytic_fwd_ms": 1e3 * e["analytic_fwd_s"],
            "analytic_bwd_ms": 1e3 * e["analytic_bwd_s"],
            "bound_fwd_ms": 1e3 * fb, "bound_fwd_bwd_ms": 1e3 * tb,
            "measured_fwd_bwd_ms": 1e3 * rec.total_s,
            "repeats": rec.repeats}
    views = sorted({str(list(e["view"][1])) for e in table})
    out = {"workers": workers, "compile_s": secs,
           "search_s": phases.get("strategy_search"), "phases_s": phases,
           "measured_keys": len(meas.measurements),
           "fallbacks": meas.fallbacks, "searched_cost": model.searched_cost,
           "winner_ops": [e["op_type"] for e in table],
           "winner_view_dims": views, "by_op_type": by_type,
           "measurement_launches": counts,
           "measurement_launches_by_path": {k: v for k, v in paths.items()
                                            if v}}
    log(f"  search x{workers}: compile {secs:.1f}s (search "
        f"{out['search_s']:.1f}s), {out['measured_keys']} keys measured, "
        f"cost {model.searched_cost:.6g}, views {views}, flash "
        f"{out['measurement_launches_by_path']}")
    for t, r in by_type.items():
        log(f"    {t}: fwd {r['measured_fwd_ms']:.4f} ms (analytic "
            f"{r['analytic_fwd_ms']:.4f}, bound {r['bound_fwd_ms']:.4f}); "
            f"bwd {r['measured_bwd_ms']:.4f} ms (analytic "
            f"{r['analytic_bwd_ms']:.4f}); fwd+bwd bound "
            f"{r['bound_fwd_bwd_ms']:.4f}")
    return model, out


def compute_ops(model):
    return [op for op in model.executor.topo if not op.is_parallel_op]


def compute_signature(model):
    """The compiled graph's compute ops in topo order: type, weight names
    and shapes (not op names: a rule's rewrite names the op it builds
    afresh, in both packages)."""
    return [(op.op_type.name, tuple(op.weight_names),
             tuple(tuple(w.material_shape()) for w in op.weights))
            for op in compute_ops(model)]


def search(torch):
    """The Unity search on the card: the flagship (bench.py's default
    leg at full width) searched with the measured mode for 1 H100 and for
    8 simulated H100s (the winner exported to chiprun_out/ and read back
    by import_strategy), each winner demoted to the one card and trained
    SEARCH_STEPS steps beside an unsearched compile on the same batches."""
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.runtime.strategy_io import import_strategy

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    export = os.path.join(out_dir, f"search_strategy_x{SEARCH_WORKERS}.json")
    if os.path.exists(export):
        os.remove(export)
    t_phase = time.perf_counter()
    total = {k: 0 for k in build.launch_counts}
    runs, models = {}, {}
    for workers in (1, SEARCH_WORKERS):
        models[workers], runs[workers] = search_run(
            torch, workers, export if workers > 1 else "")
        for k, v in runs[workers]["measurement_launches"].items():
            total[k] += v
    recs = import_strategy(export)
    if len(recs) != len(models[SEARCH_WORKERS].searched_views):
        raise AssertionError(f"exported strategy: {len(recs)} records for "
                             f"{len(models[SEARCH_WORKERS].searched_views)} "
                             "ops")
    runs[SEARCH_WORKERS]["exported"] = os.path.relpath(export, REPO)
    runs[SEARCH_WORKERS]["exported_records"] = len(recs)
    # training: the unsearched compile and each winner from the same
    # weights, on the same batches
    base = build_transformer_model(torch)
    lowering = compute_signature(base)
    start = {op: {n: w.clone() for n, w in ws.items()}
             for op, ws in base.params.items()}
    rng = np.random.RandomState(43)
    x, y = (rng.randn(SEARCH_STEPS * TRAIN_BATCH, TRAIN_SEQ,
                      HIDDEN).astype(np.float32) for _ in range(2))
    build.reset_launch_counts()
    _, lines_base, _ = fit_lines(torch, base, x, y, 1)
    for workers, m in models.items():
        same_ops = compute_signature(m) == lowering
        if same_ops:
            # the winner's op for each of the lowering's, by position
            name = {a.name: b.name
                    for a, b in zip(compute_ops(base), compute_ops(m))}
            with torch.no_grad():
                for op, ws in start.items():
                    for n, w in ws.items():
                        m.params[name[op]][n].copy_(w)
        _, lines, _ = fit_lines(torch, m, x, y, 1)
        gap = (weight_gap(torch, base, types.SimpleNamespace(params={
            op: m.params[name[op]] for op in base.params}))
            if same_ops else None)
        runs[workers]["training"] = {
            "steps": SEARCH_STEPS, "keeps_lowering_ops": same_ops,
            "epoch_line": lines, "unsearched_epoch_line": lines_base,
            "weights_vs_unsearched": gap}
        if same_ops:
            if gap["weights_not_bit_equal"] or lines != lines_base:
                raise AssertionError(f"search x{workers}: the winner trained "
                                     f"apart from the unsearched compile: "
                                     f"{gap}, {lines} vs {lines_base}")
        else:
            la = float(re.search(r"loss=(\S+)", lines[0]).group(1))
            lb = float(re.search(r"loss=(\S+)", lines_base[0]).group(1))
            runs[workers]["training"]["loss_rel_diff"] = abs(la - lb) / lb
            if not abs(la - lb) <= SEARCH_LOSS_RTOL * abs(lb):
                raise AssertionError(f"search x{workers}: loss {la} vs "
                                     f"unsearched {lb}")
        log(f"  search x{workers}: winner trained {SEARCH_STEPS} steps, "
            f"keeps the lowering's ops: {same_ops}; vs unsearched {gap}")
    train_counts = dict(build.launch_counts)
    for k, v in train_counts.items():
        total[k] += v
    check_wgmma_paths("search training", train_counts, build.path_counts)
    # three fits of SEARCH_STEPS steps
    check_training_counts("search training", train_counts, {
        "flash_fwd": 3 * SEARCH_STEPS * LAYERS,
        "flash_bwd": 3 * SEARCH_STEPS * LAYERS, "paged_decode": 0})
    return {"model": "flagship Transformer (bench.py's default leg), "
                     f"search_budget {SEARCH_BUDGET}, measured",
            "x1": runs[1], f"x{SEARCH_WORKERS}": runs[SEARCH_WORKERS],
            "training_launches": train_counts, "launches": total,
            "phase_s": time.perf_counter() - t_phase}


# -- the seq2seq phase: encoder-decoder serving -------------------------------
# Transformer (big) (Vaswani et al. 2017, "Attention Is All You Need",
# Table 3 row "big"): d_model 1024, 16 heads of 64, d_ff 4096, 6 encoder
# and 6 decoder post-LN blocks, ReLU FFN, sinusoidal positions (section
# 3.5) added as constant tensors, embeddings scaled by sqrt(d_model), the
# En-Fr word-piece vocabulary of 32000 (section 5.1). Cuts: untied
# embedding/softmax weights (FFModel has no weight sharing); no dropout
# or label smoothing (training only). Source length 128, decoder cap 128,
# bf16 compute over f32 weights, random weights from the seed.
S2S_VOCAB, S2S_D, S2S_HEADS, S2S_FF, S2S_LAYERS = 32000, 1024, 16, 4096, 6
S2S_BATCH, S2S_SRC, S2S_DEC, S2S_NEW = 8, 128, 128, 64
S2S_BEAMS, S2S_BEAM_SOURCES, S2S_BEAM_NEW = 4, 4, 32
# The cached logits against the full forward, per decoder position: max
# over the vocab of |cached - forward| over the max |forward| of the row.
# Each path rounds its activations to bf16 at other places (the flash
# kernel's P against the paged kernel's f32 P, the cross-attention's
# plain products against the flash kernel's), a few 2^-9 relative steps
# a layer; post-LN keeps them from compounding, so 12 blocks should stay
# within a few percent of the row's largest logit: 0.05, the serving
# LM's limit (LOGIT_RTOL), predicted before the first reading.
S2S_LOGIT_RTOL = 0.05
# The logits must not be vacuous: every row's standard deviation over the
# vocabulary at least this (glorot's output projection over unit-scale
# layer-normed activations gives ~sqrt(1024) * 0.0135 / sqrt(3) ~ 0.25).
S2S_LOGIT_STD_FLOOR = 0.05
# A returned beam rescored through the full forward: its summed log-prob
# against the incremental scorer's (the same tokens teacher-forced
# through the decode step). Per token the two log-probs differ by about
# the logits' error (a few hundredths worst); over 32 tokens of ~-10 each
# that is well under 1% of the sum.
S2S_BEAM_SCORE_RTOL = 0.01
# NMT's full-forward beam search (examples/python/nmt.py -b 32 widths,
# its softmax head): NMT_BEAM_SOURCES sources, NMT_BEAM_NEW tokens.
NMT_BEAM_SOURCES, NMT_BEAM_NEW = 4, 16
# The primitive-op attention decoder at the serving LM's width: 2 blocks
# of batch_matmul attention with a baked tril mask, batch 8, 128
# positions (the mask's length caps the decode).
PRIM_LAYERS, PRIM_LEN = 2, 128
# compile_decode on the serving LM (cut to COMPILE_DECODE_LAYERS blocks),
# searched for SEARCH_WORKERS simulated H100s under the decode
# objective, then a ContinuousBatcher on its executor.
COMPILE_DECODE_LAYERS = 2
# The seq2seq shapes the kernels are held at: the encoder's flash forward
# (8 rows x 16 heads, 128 x 128, non-causal) and the decoder's paged
# decode (8 slots x 16 heads, cap 128).
S2S_PAGED_LENGTHS = (1, 17, 40, 64, 65, 100, 127, 128)


def sinusoid(n, d):
    """The paper's positional encoding (section 3.5), (n, d) float32."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(d // 2, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((n, d))
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return out.astype(np.float32)


def build_seq2seq_model(torch, batch=S2S_BATCH, layers=S2S_LAYERS):
    """Transformer (big) through the FFModel API."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import ActiMode, AggrMode, DataType

    m = FFModel(FFConfig(batch_size=batch, allow_mixed_precision=True,
                         seed=0))
    d = S2S_D
    src = m.create_tensor((batch, S2S_SRC), DataType.DT_INT32)
    tgt = m.create_tensor((batch, S2S_DEC), DataType.DT_INT32)

    def embed(ids, n):
        e = m.embedding(ids, S2S_VOCAB, d, AggrMode.AGGR_MODE_NONE)
        e = m.scalar_multiply(e, float(np.sqrt(d)))
        return m.add(e, m.create_constant_tensor(sinusoid(n, d)[None],
                                                 DataType.DT_FLOAT))

    def ffn(x):
        f = m.dense(x, S2S_FF, ActiMode.AC_MODE_RELU)
        return m.layer_norm(m.add(x, m.dense(f, d)))

    e = embed(src, S2S_SRC)
    for _ in range(layers):
        e = m.layer_norm(m.add(e, m.multihead_attention(e, e, e, d,
                                                        S2S_HEADS)))
        e = ffn(e)
    x = embed(tgt, S2S_DEC)
    for _ in range(layers):
        x = m.layer_norm(m.add(x, m.multihead_attention(
            x, x, x, d, S2S_HEADS, causal=True)))
        x = m.layer_norm(m.add(x, m.multihead_attention(x, e, e, d,
                                                        S2S_HEADS)))
        x = ffn(x)
    m.dense(x, S2S_VOCAB)
    m.compile()
    return m


def cached_logits(torch, model, src, dec, n, batch):
    """Logits of decoder positions 0..n-1 through the decode step, one
    token a step at per-row positions (replays on the card): (batch, n,
    vocab) float32."""
    init, step = model.executor.build_decode(batch, S2S_DEC)
    caches = init(model.params, [src])
    out = []
    for t in range(n):
        logits, _ = step(model.params, caches, np.full(batch, t, np.int32),
                         [dec[:, t:t + 1]])
        out.append(logits[:, 0].float())
    return torch.stack(out, 1)


def full_logits(torch, model, src, dec, n):
    """The full forward's logits of decoder positions 0..n-1 (the decoder
    buffer padded to its compiled length)."""
    padded = np.zeros((dec.shape[0], S2S_DEC), np.int32)
    padded[:, :dec.shape[1]] = dec
    return model.executor.build_forward()(model.params, [src, padded])[
        :, :n].float()


def hold_logits(torch, what, cached, full, rtol):
    """The cached logits against the full forward's: per position the
    max error over the row's max |logit| (under rtol), the argmax
    agreement, and the rows' spread over the vocabulary (above
    S2S_LOGIT_STD_FLOOR: not vacuous)."""
    if not (torch.isfinite(cached).all() and torch.isfinite(full).all()):
        raise AssertionError(f"{what}: non-finite logits")
    rel = (cached - full).abs().amax(-1) / full.abs().amax(-1)
    err, mean_err = rel.max().item(), rel.mean().item()
    agree = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
    spread = full.std(-1).min().item()
    if not err <= rtol:
        raise AssertionError(f"{what}: cached vs forward {err} > {rtol}")
    if not spread >= S2S_LOGIT_STD_FLOOR:
        raise AssertionError(f"{what}: a logit row's std {spread} < "
                             f"{S2S_LOGIT_STD_FLOOR}: vacuous logits")
    return {"max_rel_err": err, "mean_rel_err": mean_err, "tol": rtol,
            "argmax_agree": agree, "min_row_std": spread,
            "row_std_floor": S2S_LOGIT_STD_FLOOR}


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def seq2seq_step_profile(torch, model, src, toks):
    """One warm captured decoder step (every row at the last generated
    position, the caches of `src`), traced, beside the host-clock time of
    such a step (best of 5)."""
    init, step = model.executor.build_decode(S2S_BATCH, S2S_DEC)
    caches = init(model.params, [src])
    t = np.full(S2S_BATCH, S2S_NEW - 1, np.int32)
    tok = toks[:, S2S_NEW - 1:S2S_NEW]
    times = []
    for _ in range(7):
        _, dt = timed(torch, lambda: step(model.params, caches, t, [tok]))
        times.append(1e3 * dt)
    prof = profile_step(torch, lambda: step(model.params, caches, t, [tok]))
    host = min(times[2:])
    log(f"  seq2seq decode step ({S2S_BATCH} rows at {S2S_NEW - 1}, "
        f"captured): {host:.3f} ms on the host clock, device busy "
        f"{prof['device_busy_ms']:.3f} ms, idle share "
        f"{max(0.0, 1.0 - prof['device_busy_ms'] / host):.4f}")
    return {"step_ms_reading": host, "device_busy_ms": prof[
        "device_busy_ms"], "idle_share_host_clock": max(
        0.0, 1.0 - prof["device_busy_ms"] / host),
        "by_family_ms": prof["by_family_ms"],
        "events_by_family": prof["events_by_family"]}


def seq2seq_generation(torch, model):
    """incremental_seq2seq_generate (captured against eager, cached
    logits against the full forward, on two source batches in a row) and
    incremental_beam_generate (captured against eager, each beam
    rescored through the full forward, num_beams 1 against greedy)."""
    from flexflow_tpu_torch.runtime.serving import (
        _log_softmax, incremental_beam_generate, incremental_generate,
        incremental_seq2seq_generate)

    rng = np.random.RandomState(11)
    out = {}
    runs = []
    for k in range(2):   # two source batches: new caches, new statics
        src = rng.randint(0, S2S_VOCAB, (S2S_BATCH, S2S_SRC)).astype(np.int32)
        toks, dt = timed(torch, lambda: incremental_seq2seq_generate(
            model, src, max_new_tokens=S2S_NEW))
        eager, dt_e = timed(torch, lambda: incremental_seq2seq_generate(
            model, src, max_new_tokens=S2S_NEW, _eager=True))
        if not np.array_equal(toks, eager):
            at = int(np.argmax((toks != eager).any(0)))
            raise AssertionError(f"seq2seq batch {k}: captured and eager "
                                 f"steps disagree from position {at}")
        n = toks.shape[1]
        held = hold_logits(torch, f"seq2seq batch {k}",
                           cached_logits(torch, model, src, toks, n,
                                         S2S_BATCH),
                           full_logits(torch, model, src, toks, n),
                           S2S_LOGIT_RTOL)
        runs.append({"s": dt, "tokens_per_s": S2S_BATCH * S2S_NEW / dt,
                     "step_ms": 1e3 * dt / S2S_NEW, "eager_s": dt_e,
                     "eager_tokens_per_s": S2S_BATCH * S2S_NEW / dt_e,
                     "exact_vs_eager": True, "cached_vs_forward": held,
                     "distinct_tokens": int(len(np.unique(toks[:, 1:])))})
        log(f"  incremental_seq2seq_generate batch {k}: {S2S_BATCH}x"
            f"{S2S_NEW} tokens in {dt:.3f}s ({S2S_BATCH * S2S_NEW / dt:.1f} "
            f"tokens/s; eager {dt_e:.3f}s), equal to eager; cached vs "
            f"forward {held['max_rel_err']:.4g} (tol {S2S_LOGIT_RTOL}), "
            f"argmax agree {held['argmax_agree']:.4f}, min row std "
            f"{held['min_row_std']:.3g}")
        if k == 0:
            first = toks
    if np.array_equal(first, toks):
        raise AssertionError("two source batches gave the same tokens")
    out["incremental_seq2seq_generate"] = {
        "batch": S2S_BATCH, "src_len": S2S_SRC, "new_tokens": S2S_NEW,
        "runs": runs, "step_profile": seq2seq_step_profile(
            torch, model, src, toks)}
    # beam search: num_beams 4 over 4 sources
    src = rng.randint(0, S2S_VOCAB, (S2S_BEAM_SOURCES, S2S_SRC)) \
        .astype(np.int32)
    starts = np.zeros((S2S_BEAM_SOURCES, 1), np.int32)
    kw = dict(max_new_tokens=S2S_BEAM_NEW, max_len=S2S_DEC, encoder_ids=src)
    beams, dt = timed(torch, lambda: incremental_beam_generate(
        model, starts, num_beams=S2S_BEAMS, **kw))
    eager, dt_e = timed(torch, lambda: incremental_beam_generate(
        model, starts, num_beams=S2S_BEAMS, _eager=True, **kw))
    if not np.array_equal(beams, eager):
        raise AssertionError("beam search: captured and eager steps "
                             "disagree")
    # each returned beam's summed log-prob: the incremental scorer (the
    # beam teacher-forced through the decode step) against the full
    # forward
    n = beams.shape[1] - 1
    inc = cached_logits(torch, model, src, beams, n, S2S_BEAM_SOURCES)
    full = full_logits(torch, model, np.concatenate([src, src]),
                       np.concatenate([beams, beams]), n)[:S2S_BEAM_SOURCES]
    idx = beams[:, 1:]

    def score(lg):
        lp = _log_softmax(lg.cpu().numpy().astype(np.float64))
        return np.take_along_axis(lp, idx[..., None], -1)[..., 0].sum(-1)

    s_inc, s_full = score(inc), score(full)
    rel = np.abs(s_inc - s_full) / np.abs(s_full)
    if not rel.max() <= S2S_BEAM_SCORE_RTOL:
        raise AssertionError(f"beam rescoring: {s_inc} vs {s_full}")
    # num_beams 1 is greedy on the same (batch 1) decode build
    one = incremental_beam_generate(model, starts, num_beams=1, **kw)
    greedy = np.concatenate([incremental_generate(
        model, starts[i:i + 1], max_new_tokens=S2S_BEAM_NEW,
        max_len=S2S_DEC, static_inputs=[src[i:i + 1]])
        for i in range(S2S_BEAM_SOURCES)])
    ties = equal_or_tie(torch, model, src, one, greedy)
    out["incremental_beam_generate"] = {
        "num_beams": S2S_BEAMS, "sources": S2S_BEAM_SOURCES,
        "new_tokens": S2S_BEAM_NEW, "s": dt,
        "tokens_per_s": S2S_BEAM_SOURCES * S2S_BEAM_NEW / dt,
        "eager_s": dt_e, "exact_vs_eager": True,
        "score_incremental": s_inc.tolist(), "score_full": s_full.tolist(),
        "score_max_rel_err": float(rel.max()), "score_tol":
        S2S_BEAM_SCORE_RTOL, "one_beam_equals_greedy": ties == 0,
        "one_beam_rows_apart_at_an_exact_tie": ties}
    log(f"  incremental_beam_generate: {S2S_BEAM_SOURCES} sources x "
        f"{S2S_BEAMS} beams x {S2S_BEAM_NEW} tokens in {dt:.3f}s (eager "
        f"{dt_e:.3f}s), equal to eager; rescored max rel err "
        f"{rel.max():.3g} (tol {S2S_BEAM_SCORE_RTOL}); num_beams 1 == "
        f"greedy ({ties} rows apart from an exact bf16 tie on)")
    return out


def equal_or_tie(torch, model, src, a, b):
    """num_beams 1 against greedy, both on the batch-1 decode build: equal
    token for token, except that a row may part where the two tokens'
    logits are exactly equal (bf16 logits over 32000 words tie now and
    then; greedy's argmax takes the lower index, the beam's top-k either).
    Returns how many rows parted at such a tie; raises on any other
    difference."""
    ties = 0
    for i in range(a.shape[0]):
        apart = np.nonzero(a[i] != b[i])[0]
        if not len(apart):
            continue
        j = int(apart[0])
        lg = cached_logits(torch, model, src[i:i + 1], a[i:i + 1], j, 1)[
            0, j - 1]
        if lg[int(a[i, j])].item() != lg[int(b[i, j])].item():
            raise AssertionError(f"num_beams 1 differs from greedy in row "
                                 f"{i} at {j}, not at a tie")
        ties += 1
    return ties


def nmt_beam(torch):
    """beam_generate on NMT at its published widths (softmax head):
    output_probability_like, num_beams 1 against greedy_generate, and
    a 4-beam search timed."""
    from flexflow_tpu_torch.runtime.serving import (beam_generate,
                                                    greedy_generate)

    m = build_nmt_model(torch)
    if m.output_probability_like() is not True:
        raise AssertionError("NMT: output_probability_like is not True")
    src = np.random.RandomState(12).randint(
        0, NMT_VOCAB, (NMT_BATCH, NMT_LEN)).astype(np.int32)
    greedy = greedy_generate(m, src, max_new_tokens=NMT_BEAM_NEW)
    one = beam_generate(m, src[:NMT_BEAM_SOURCES], num_beams=1,
                        max_new_tokens=NMT_BEAM_NEW)
    if not np.array_equal(one, greedy[:NMT_BEAM_SOURCES]):
        raise AssertionError("NMT: num_beams 1 differs from greedy")
    beams, dt = timed(torch, lambda: beam_generate(
        m, src[:NMT_BEAM_SOURCES], num_beams=S2S_BEAMS,
        max_new_tokens=NMT_BEAM_NEW))
    log(f"  NMT beam_generate: {NMT_BEAM_SOURCES} sources x {S2S_BEAMS} "
        f"beams x {NMT_BEAM_NEW} tokens in {dt:.3f}s; num_beams 1 == "
        "greedy_generate")
    return {"model": "build_nmt (examples/python/nmt.py -b 32)",
            "output_probability_like": True, "sources": NMT_BEAM_SOURCES,
            "num_beams": S2S_BEAMS, "new_tokens": NMT_BEAM_NEW, "s": dt,
            "one_beam_equals_greedy": True,
            "shape": list(beams.shape)}


def build_primitive_decoder(torch):
    """A decoder whose attention is primitive ops at the serving LM's
    width: per block q/k/v dense, reshape and transpose to heads,
    batch_matmul scores scaled by 1/8, a baked tril mask constant,
    softmax, batch_matmul with V, back to (b, s, 1024), the output dense,
    a residual and a layer norm."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.ff_types import AggrMode, DataType

    b, n, d, h = SLOTS, PRIM_LEN, HIDDEN, HEADS
    m = FFModel(FFConfig(batch_size=b, allow_mixed_precision=True, seed=0))
    ids = m.create_tensor((b, n), DataType.DT_INT32)
    x = m.embedding(ids, VOCAB, d, AggrMode.AGGR_MODE_NONE)
    mask = np.where(np.tril(np.ones((n, n), bool)), 0.0, -1e9) \
        .astype(np.float32)[None, None]
    for _ in range(PRIM_LAYERS):
        def heads(t):
            return m.transpose(m.reshape(m.dense(t, d), (b, n, h, d // h)),
                               (0, 2, 1, 3))
        q, k, v = heads(x), heads(x), heads(x)
        s = m.batch_matmul(q, m.transpose(k, (0, 1, 3, 2)))
        s = m.add(m.scalar_multiply(s, 1.0 / np.sqrt(d // h)),
                  m.create_constant_tensor(mask, DataType.DT_FLOAT))
        a = m.batch_matmul(m.softmax(s, axis=-1), v)
        a = m.reshape(m.transpose(a, (0, 2, 1, 3)), (b, n, d))
        x = m.layer_norm(m.add(x, m.dense(a, d)))
    m.softmax(m.dense(x, VOCAB))
    m.compile()
    return m


def primitive_decoder(torch):
    """build_decode without assume_causal (the baked mask proves the
    attention causal), prefix caches, and per-row replayed steps against
    the full forward; incremental_generate captured against eager."""
    from flexflow_tpu_torch.runtime.serving import incremental_generate

    m = build_primitive_decoder(torch)
    init, _ = m.executor.build_decode(SLOTS, PRIM_LEN)
    prefix = len(init(m.params)["prefix"])
    if prefix != 2 * PRIM_LAYERS:
        raise AssertionError(f"primitive decoder: {prefix} prefix caches")
    prompts = np.random.RandomState(13).randint(
        0, VOCAB, (SLOTS, 16)).astype(np.int32)
    toks, dt = timed(torch, lambda: incremental_generate(
        m, prompts, max_new_tokens=PRIM_LEN - 16, max_len=PRIM_LEN))
    eager = incremental_generate(m, prompts, max_new_tokens=PRIM_LEN - 16,
                                 max_len=PRIM_LEN, _eager=True)
    if not np.array_equal(toks, eager):
        raise AssertionError("primitive decoder: captured and eager steps "
                             "disagree")
    err, _, _ = check_cached_vs_forward(torch, m, toks, 16, PRIM_LEN,
                                        per_row=True)
    log(f"  primitive-op decoder ({PRIM_LAYERS} blocks, width {HIDDEN}): "
        f"built without assume_causal, {prefix} prefix caches; "
        f"{SLOTS}x{PRIM_LEN - 16} tokens in {dt:.3f}s, equal to eager; "
        f"cached vs forward {err:.4g} (tol {LOGIT_RTOL})")
    return {"blocks": PRIM_LAYERS, "width": HIDDEN, "heads": HEADS,
            "len": PRIM_LEN, "prefix_caches": prefix, "s": dt,
            "tokens_per_s": SLOTS * (PRIM_LEN - 16) / dt,
            "exact_vs_eager": True, "cached_vs_forward_max_rel_err": err,
            "tol": LOGIT_RTOL}


def compile_decode_serving(torch):
    """compile_decode on the serving LM (SEARCH_WORKERS simulated H100s,
    the decode objective), then a ContinuousBatcher on its executor:
    decode_strategy_active, every answer equal to incremental_generate's,
    the page pool clean."""
    from flexflow_tpu_torch.runtime.serving import (AdmissionQueue,
                                                    ContinuousBatcher,
                                                    GenerationRequest,
                                                    ServingConfig,
                                                    incremental_generate)

    model = build_model(torch, layers=COMPILE_DECODE_LAYERS,
                        search_num_workers=SEARCH_WORKERS)
    ids = np.random.RandomState(14).randint(0, VOCAB, (SLOTS, MAX_LEN))
    unit_scale_weights(torch, model, ids.astype(np.int32))
    t0 = time.perf_counter()
    model.compile_decode()
    search_s = time.perf_counter() - t0
    views = sorted({tuple(v.dim) for v in
                    model.decode_searched_views.values()})
    lens = [16, 40, 64, 97, 128, 150]
    new = 16
    rng = np.random.RandomState(15)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32) for n in lens]
    q = AdmissionQueue(max_depth=len(lens))
    b = ContinuousBatcher(model, ServingConfig(max_len=MAX_LEN, slots=SLOTS,
                                               page_size=16), q)
    if not b.decode_strategy_active:
        raise AssertionError("the batcher did not take the decode executor")
    reqs = [GenerationRequest(p, new, deadline_s=600.0) for p in prompts]
    t0 = time.perf_counter()
    b.start()
    try:
        for r in reqs:
            q.offer(r)
        outs = [r.result(timeout=600) for r in reqs]
    finally:
        b.stop()
    dt = time.perf_counter() - t0
    if b.dead or b.stats["finished"] != len(reqs):
        raise AssertionError(f"batcher: {b.stats}, died: {b.death_cause!r}")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        ref = incremental_generate(model, p[None], max_new_tokens=new,
                                   max_len=MAX_LEN)[0]
        if not np.array_equal(o, ref):
            raise AssertionError(f"decode-executor batcher: request {i} "
                                 "differs from incremental_generate")
    if b.pool.audit() or b.pool.pages_in_use:
        raise AssertionError(f"page pool not clean: {b.pool.audit()}")
    log(f"  compile_decode (serving LM, {COMPILE_DECODE_LAYERS} blocks, "
        f"{SEARCH_WORKERS} simulated H100s): {search_s:.2f}s, cost "
        f"{model.decode_searched_cost:.6g}, views {views}; batcher on the "
        f"decode executor: {len(reqs)} requests exact, pool clean")
    return {"layers": COMPILE_DECODE_LAYERS, "workers": SEARCH_WORKERS,
            "search_s": search_s, "searched_cost": model.decode_searched_cost,
            "winner_view_dims": [list(v) for v in views],
            "phases_s": {e["name"]: e["dur"] for e in
                         model.decode_trajectory.of_kind("phase")},
            "decode_strategy_active": True, "requests": len(reqs),
            "new_tokens": new, "batcher_s": dt,
            "exact_vs_incremental_generate": len(reqs),
            "pool_audit_ok": True}


def check_seq2seq_kernels(torch, rng_seed=4):
    """Both kernels of the path held against their plain versions at the
    seq2seq shapes, and timed beside SDPA and their bound: the encoder's
    flash forward (non-causal, 8 x 16 rows of 128 x 128, d 64) and the
    decoder's paged decode (8 slots x 16 heads, cap 128, the strided
    cache view)."""
    from flexflow_tpu_torch.kernels import attention as ka
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.kernels import decode as kd

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    bf16 = torch.bfloat16
    bh, s, d = S2S_BATCH * S2S_HEADS, S2S_SRC, S2S_D // S2S_HEADS
    q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda").to(bf16)
               for _ in range(3))
    before = dict(build.path_counts)
    o, _ = ka._flash_fwd_cuda(q, k, v, causal=False)
    po, _ = ka.flash_fwd_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    expect_path("seq2seq flash", before, "flash_fwd", "wgmma")
    eo, ratio = check_close("seq2seq flash", "flash_fwd", o, po)
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
    # q, k, v read and O written in bf16, lse written in f32; QK^T and PV
    b_ms, b_by = bound_ms(2 * 4 * bh * s * d + 4 * bh * s,
                          bh * s * s * 4 * d)
    flash = {"shape": f"bh={bh} sq=sk={s} d=dv={d} non-causal bf16 (the "
                      "encoder's self-attention), L2 warm",
             "max_abs_err": eo, "err_over_limit": ratio,
             "ms": time_ms(lambda: ka._flash_fwd_cuda(q, k, v,
                                                      causal=False), 50),
             "plain_ms": time_ms(lambda: ka.flash_fwd_plain(
                 q, k, v, causal=False), 10),
             "library_ms": time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q4, k4, v4), 50),
             "bound_ms": b_ms, "bound_by": b_by}
    h, lens = S2S_HEADS, S2S_PAGED_LENGTHS
    page = kd.decode_page_size(S2S_DEC)
    kc, vc = (torch.randn(S2S_BATCH, S2S_DEC, h, d, generator=g,
                          device="cuda").to(bf16) for _ in range(2))
    qd = torch.randn(S2S_BATCH, h, d, generator=g, device="cuda").to(bf16)
    kp, vp, table = kd.paged_view_of_cache(kc, vc, page)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (qd, kp, vp, table, lengths)
    before = dict(build.path_counts)
    out = kd._paged_decode_cuda(*args)
    plain = kd.paged_decode_plain(*args)
    torch.cuda.synchronize()
    expect_path("seq2seq paged", before, "paged_decode", "cluster")
    ep, pratio = check_close("seq2seq paged", "paged_decode", out, plain)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    mask = (torch.arange(S2S_DEC, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    pb_ms, pb_by = paged_bound(lens, h, d, d, page)
    paged = {"shape": (f"{S2S_BATCH} slots x {h} heads, d {d}, cap "
                       f"{S2S_DEC}, page {page}, lengths "
                       + "/".join(map(str, lens)) + ", strided cache view, "
                       "bf16, L2 cold"),
             "max_abs_err": ep, "err_over_limit": pratio,
             "ms": time_ms(lambda: kd._paged_decode_cuda(*args), 50,
                           flush_buf.zero_),
             "plain_ms": time_ms(lambda: kd.paged_decode_plain(*args), 3,
                                 flush_buf.zero_, per_launch=True),
             "library_ms": time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                     attn_mask=mask), 50, flush_buf.zero_),
             "bound_ms": pb_ms, "bound_by": pb_by,
             "ranks": kd.paged_ranks(table.shape[1], page)}
    log(f"  seq2seq kernels: flash (non-causal {bh}x{s}x{s}) "
        f"{flash['ms']:.4f} ms, plain {flash['plain_ms']:.4f}, SDPA "
        f"{flash['library_ms']:.4f}, bound {b_ms:.5f} ({b_by}), err "
        f"{eo:.3g}; paged (cap {S2S_DEC}) {paged['ms']:.5f} ms, plain "
        f"{paged['plain_ms']:.4f}, SDPA {paged['library_ms']:.5f}, bound "
        f"{pb_ms:.5f} ({pb_by}), err {ep:.3g}")
    return {"flash_fwd": flash, "paged_decode": paged}


def seq2seq(torch):
    """The encoder-decoder serving phase: Transformer (big) through
    incremental_seq2seq_generate and incremental_beam_generate, NMT's
    beam_generate, the primitive-op attention decoder and compile_decode
    with the batcher on its executor; every kernel launch of those runs
    counted, then both kernels held against their plain versions at the
    seq2seq shapes (those launches not counted)."""
    from flexflow_tpu_torch.kernels import build

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    model, build_s = timed(torch, lambda: build_seq2seq_model(torch))
    summary = {"model": "Transformer (big), Vaswani et al. 2017 Table 3",
               "d_model": S2S_D, "heads": S2S_HEADS, "d_ff": S2S_FF,
               "layers": f"{S2S_LAYERS}+{S2S_LAYERS}", "vocab": S2S_VOCAB,
               "src_len": S2S_SRC, "dec_cap": S2S_DEC,
               "precision": "bf16 compute over f32 weights",
               "weights": sum(w.numel() for ws in model.params.values()
                              for w in ws.values()), "build_s": build_s}
    summary.update(seq2seq_generation(torch, model))
    del model
    torch.cuda.empty_cache()
    summary["nmt_beam_generate"] = nmt_beam(torch)
    summary["primitive_decoder"] = primitive_decoder(torch)
    summary["compile_decode"] = compile_decode_serving(torch)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    check_wgmma_paths("seq2seq", counts, build.path_counts)
    paged = {k: build.path_counts[k] for k in ("paged_decode_cluster",
                                               "paged_decode_block")}
    if paged != {"paged_decode_cluster": counts["paged_decode"],
                 "paged_decode_block": 0}:
        raise AssertionError(f"seq2seq: paged launches by path {paged}, "
                             "expected all on cluster")
    if not (counts["flash_fwd"] and counts["paged_decode"]):
        raise AssertionError(f"a kernel of the seq2seq path never "
                             f"launched: {counts}")
    summary.update(launches=counts,
                   launches_by_path=dict(build.path_counts),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    summary["kernels"] = check_seq2seq_kernels(torch)
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary


# The resilience phase: BERT-base at the BERT phase's widths and data
# seed, SGD with momentum 0.9 at lr 1e-3 (which keeps its 12 steps
# finite; the BERT phase's 0.01 diverges within tens of steps), one
# epoch of RES_BATCHES batches. The step guard starts at scale 1024 and
# regrows every 3 good steps, so a NaN step at index 4 backs it off to
# 512 and indices 5-7 grow it back; checkpoints every 3 steps, the last
# 2 kept; run B is hard-killed before step index 8.
RES_BATCHES, RES_LR, RES_MOMENTUM = 12, 1e-3, 0.9
RES_SCALE, RES_GROWTH = 1024.0, 3
RES_NAN_AT, RES_PREEMPT_AT, RES_EVERY, RES_KEEP = 4, 8, 3, 2
RES_PLAIN_BATCHES = 4
RES_ABBA_ROUNDS, RES_TURN_STEPS, RES_TIMED_IO = 5, 4, 3
# the optional finding: the BERT phase's SGD lr 0.01 without momentum
# under the default guard (scale 1, 10 skips in a row fail the run)
RES_DIVERGE_EPOCHS = 4


def device_digest(torch, tensors):
    """One int64 per tensor, on the device: the position-weighted sum of
    its 32-bit words (2i + 1 for word i, wrapping), so equal digests mean
    bit-equal tensors up to a collision. Every tensor here is 32-bit."""
    out = []
    for t in tensors:
        words = t.detach().contiguous().reshape(-1).view(torch.int32) \
            .to(torch.int64)
        pos = torch.arange(words.numel(), device=words.device,
                           dtype=torch.int64) * 2 + 1
        out.append((words * pos).sum())
    return torch.stack(out)


def record_each_step(model, on_step):
    """Wrap the executor's build_train_step so that `on_step(state)` sees
    the state after each step of the next fit; `del model.executor.
    build_train_step` unwraps. The script's observation, not the path:
    the step itself is unchanged."""
    ex = model.executor
    build_step = type(ex).build_train_step

    def build():
        step = build_step(ex)

        def run(*a, **k):
            state, partials = step(*a, **k)
            on_step(state)
            return state, partials
        return run

    ex.build_train_step = build


def quiet_fit(model, x, y, **kw):
    """`fit` with its printout captured and logged; returns the text."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.fit(x, y, **kw)
    text = out.getvalue()
    log("  " + text.strip().replace("\n", "\n  "))
    return text


def state_tensors(model):
    """Every tensor of a model's training state by name: weights,
    optimizer state, the guard's counters."""
    from flexflow_tpu_torch.runtime.verify import (_flat_path,
                                                   _leaves_with_path)

    st = model.state
    tree = {"params": st.params, "opt_state": st.opt_state,
            "guard": st.guard.as_dict() if st.guard is not None else None}
    return {_flat_path(p): t for p, t in _leaves_with_path(tree)
            if t is not None}


def states_not_equal(torch, a, b, guard=True):
    """The names of the state tensors that differ in any bit (or exist in
    one model only); the guard's counters left out unless `guard`."""
    ta, tb = state_tensors(a), state_tensors(b)
    if not guard:
        ta, tb = ({k: v for k, v in t.items() if not k.startswith("guard/")}
                  for t in (ta, tb))
    return sorted(k for k in ta.keys() | tb.keys()
                  if k not in ta or k not in tb
                  or not torch.equal(ta[k], tb[k]))


def epoch_lines(text):
    """fit's epoch lines without the throughput reading (a clock)."""
    return [ln.split("throughput")[0] + ln.split("samples/s")[1]
            for ln in text.splitlines() if ln.startswith("epoch")]


def guard_overhead(torch, model, guard, x, y):
    """The guarded against the unguarded stepwise train step on the host
    clock (each step synchronised), in ABBA rounds of RES_TURN_STEPS
    steps, every turn from one snapshot of the state; beside the bound of
    the bytes the guard's extra passes move."""
    from flexflow_tpu_torch.parallel.executor import _tensors

    ex = model.executor
    restore = restorer(torch, model)
    poison = torch.ones((), dtype=torch.float32, device="cuda")

    def turn(guarded):
        restore()
        ex.set_step_guard(guard if guarded else None)
        model.state.guard = ex.init_guard_state() if guarded else None
        step = ex.build_train_step()
        gen = torch.Generator().manual_seed(1)
        times = []
        for j in range(RES_TURN_STEPS):
            sl = slice(j * BERT_BATCH, (j + 1) * BERT_BATCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.state, _ = step(model.state, [x[sl]], y[sl], gen,
                                  poison if guarded else None)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.mean(times))

    turn(False)
    turn(True)   # warm-up
    got = {"unguarded": [], "guarded": []}
    for _ in range(RES_ABBA_ROUNDS):
        for name in ("unguarded", "guarded", "guarded", "unguarded"):
            got[name].append(turn(name == "guarded"))
    restore()
    ex.set_step_guard(None)
    model.state.guard = None
    if not weights_finite(torch, model):
        raise AssertionError("the timed steps left non-finite weights")
    out = {}
    for name, v in got.items():
        med = float(np.median(v))
        out[name] = {"step_ms_median": med, "readings": v,
                     "spread": (max(v) - min(v)) / med}
    out["overhead_ms"] = (out["guarded"]["step_ms_median"]
                          - out["unguarded"]["step_ms_median"])
    # bytes: the weights (P f32) and their momentum (S f32) and the
    # gradients (P in grad_dtype). The guard's own function: unscale the
    # gradients (read, write) and take their norm (read). Its
    # implementation here adds the snapshot of the state (read, write)
    # and the select (read the new and the old, write)
    weights = sum(w.numel() for ws in model.params.values()
                  for w in ws.values())
    slots = sum(t.numel() for t in _tensors(model.state.opt_state))
    gb = torch.finfo(ex.grad_dtype or torch.float32).bits // 8
    function_bytes = 3 * weights * gb
    passes_bytes = function_bytes + 5 * 4 * (weights + slots)
    out.update(weights=weights, optimizer_slots=slots, grad_bytes=gb,
               bound_ms_function=1e3 * function_bytes / PEAK_BYTES_PER_S,
               bound_ms_passes=1e3 * passes_bytes / PEAK_BYTES_PER_S,
               bytes_function=function_bytes, bytes_passes=passes_bytes)
    return out


def resilience(torch):
    """The resilience phase: the resilient `fit` of BERT-base (dropout
    on: both flash kernels' dropout variants every step) with the step
    guard, checkpoints, a hard kill and resume, against a plain `fit`,
    and the integrity gate; then its readings. Every check raises. The
    launch counts cover runs A, B (and its resume) and the plain against
    resilient pair."""
    import shutil
    import tempfile
    import warnings

    from flexflow_tpu_torch import SGDOptimizer, obs
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.parallel.executor import _tensors
    from flexflow_tpu_torch.runtime.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)
    from flexflow_tpu_torch.runtime.resilience import (
        CheckpointManager, FaultInjector, NonFiniteGradientsError,
        StepGuardConfig, TrainingPreempted, restore_latest)
    from flexflow_tpu_torch.runtime.verify import verify_checkpoint

    t_phase = time.perf_counter()
    os.environ.pop("FF_ATTENTION_IMPL", None)
    rng = np.random.RandomState(0)
    n = RES_BATCHES * BERT_BATCH
    x, y = (rng.randn(n, BERT_SEQ, BERT_HIDDEN).astype(np.float32)
            for _ in range(2))
    guard = StepGuardConfig(init_loss_scale=RES_SCALE,
                            growth_interval=RES_GROWTH)

    def model():
        return build_bert_model(torch, optimizer=SGDOptimizer(
            lr=RES_LR, momentum=RES_MOMENTUM))

    def injector():
        return FaultInjector().inject("nan_grads", at_step=RES_NAN_AT)

    summary = {"model": "BERT-base encoder via PyTorchModel",
               "batch": BERT_BATCH, "seq": BERT_SEQ, "batches": RES_BATCHES,
               "optimizer": f"SGD lr {RES_LR} momentum {RES_MOMENTUM}",
               "guard": f"init_loss_scale {RES_SCALE}, growth_interval "
                        f"{RES_GROWTH}", "nan_at": RES_NAN_AT,
               "preempt_at": RES_PREEMPT_AT, "every": RES_EVERY,
               "keep_last_n": RES_KEEP}
    root = tempfile.mkdtemp(prefix="ff_resilience_")
    try:
        torch.cuda.synchronize()
        build.reset_launch_counts()
        # -- run A: uninterrupted, a NaN step at index RES_NAN_AT --------
        a = model()
        digests, scales = [], []

        def on_step(state):
            digests.append(device_digest(
                torch, _tensors((state.params, state.opt_state))))
            scales.append(state.guard.loss_scale.clone())

        record_each_step(a, on_step)
        dir_a = os.path.join(root, "a")
        text_a = quiet_fit(a, x, y, checkpoint_dir=dir_a,
                           checkpoint_every_n_steps=RES_EVERY,
                           keep_last_n=RES_KEEP, step_guard=guard,
                           fault_injector=injector())
        del a.executor.build_train_step
        torch.cuda.synchronize()
        if len(digests) != RES_BATCHES:
            raise AssertionError(f"run A took {len(digests)} steps")
        unchanged = [i for i in range(1, RES_BATCHES)
                     if torch.equal(digests[i], digests[i - 1])]
        if unchanged != [RES_NAN_AT]:
            raise AssertionError(f"run A: the state stood still after "
                                 f"steps {unchanged}, expected only "
                                 f"[{RES_NAN_AT}] (the NaN step)")
        scale_seq = [s.item() for s in scales]
        want = [RES_SCALE] * RES_NAN_AT + [RES_SCALE / 2] * RES_GROWTH + \
            [RES_SCALE] * (RES_BATCHES - RES_NAN_AT - RES_GROWTH)
        if scale_seq != want:
            raise AssertionError(f"run A: loss scales {scale_seq}, "
                                 f"expected {want}")
        g = a.state.guard
        if (g.total_skips.item(), g.consecutive_skips.item()) != (1, 0):
            raise AssertionError(f"run A: guard {g}")
        if "skipped_steps=1" not in text_a:
            raise AssertionError(f"run A printed {text_a!r}")
        kept = CheckpointManager(dir_a).list_steps()
        if kept != [RES_BATCHES - RES_EVERY, RES_BATCHES]:
            raise AssertionError(f"run A kept checkpoints {kept}")
        log(f"  run A: loss scales {scale_seq}; the state stood still "
            f"only after the NaN step {RES_NAN_AT}; checkpoints {kept}")
        summary["run_a"] = {"loss_scales": scale_seq,
                            "state_unchanged_after_steps": unchanged,
                            "checkpoints_kept": kept,
                            "epoch_line": epoch_lines(text_a)}

        # -- run B: hard-killed before step RES_PREEMPT_AT, resumed -------
        b = model()
        fi = injector().inject("preempt", at_step=RES_PREEMPT_AT,
                               graceful=False)
        dir_b = os.path.join(root, "b")
        try:
            quiet_fit(b, x, y, checkpoint_dir=dir_b,
                      checkpoint_every_n_steps=RES_EVERY,
                      keep_last_n=RES_KEEP, step_guard=guard,
                      fault_injector=fi)
        except TrainingPreempted as e:
            killed = e
        else:
            raise AssertionError("run B was not preempted")
        if (killed.step, killed.graceful, killed.checkpoint_path) != \
                (RES_PREEMPT_AT, False, None):
            raise AssertionError(f"run B: preempted at {killed.step}, "
                                 f"graceful {killed.graceful}, checkpoint "
                                 f"{killed.checkpoint_path}")
        del b
        torch.cuda.empty_cache()
        c = model()
        text_c = quiet_fit(c, x, y, checkpoint_dir=dir_b,
                           checkpoint_every_n_steps=RES_EVERY,
                           keep_last_n=RES_KEEP, step_guard=guard)
        resumed_at = (RES_PREEMPT_AT // RES_EVERY) * RES_EVERY
        if f"resumed from step {resumed_at} " not in text_c:
            raise AssertionError(f"run B's resume printed {text_c!r}")
        differ = states_not_equal(torch, a, c)
        if differ or c.state.step != a.state.step:
            raise AssertionError(f"run B resumed: {len(differ)} state "
                                 f"tensors differ from run A's: {differ[:8]}")
        log(f"  run B: killed before step {killed.step} (no checkpoint), "
            f"resumed from step {resumed_at}: weights, momentum and guard "
            f"bit-equal to run A's ({len(state_tensors(a))} tensors)")
        summary["run_b"] = {"preempted_at": killed.step,
                            "resumed_from": resumed_at,
                            "state_tensors_bit_equal": len(state_tensors(a))}

        # -- plain against resilient fit, from run A's state --------------
        with torch.no_grad():
            for t, v in zip(_tensors((c.state.params, c.state.opt_state)),
                            _tensors((a.state.params, a.state.opt_state))):
                t.copy_(v)
        c._rng.set_state(a._rng.get_state())
        xp = x[:RES_PLAIN_BATCHES * BERT_BATCH]
        yp = y[:RES_PLAIN_BATCHES * BERT_BATCH]
        plain = quiet_fit(c, xp, yp)
        resil = quiet_fit(a, xp, yp, checkpoint_dir=os.path.join(root, "e"))
        differ = states_not_equal(torch, a, c)
        if differ or epoch_lines(plain) != epoch_lines(resil):
            raise AssertionError(f"resilient fit against plain fit: {differ}"
                                 f" differ; {plain!r} against {resil!r}")
        log(f"  resilient fit with checkpoints, no faults, bit-equal to "
            f"plain fit over {RES_PLAIN_BATCHES} steps")
        torch.cuda.synchronize()
        counts = dict(build.launch_counts)
        paths = dict(build.path_counts)
        steps_run = (RES_BATCHES + RES_PREEMPT_AT
                     + (RES_BATCHES - resumed_at) + 2 * RES_PLAIN_BATCHES)
        per = steps_run * BERT_LAYERS
        check_training_counts("resilience", counts, {
            "flash_fwd_dropout": per, "flash_bwd_dropout": per,
            "flash_fwd": 0, "flash_bwd": 0, "paged_decode": 0})
        check_wgmma_paths("resilience", counts, paths)
        summary.update(launches=counts, launches_by_path=paths,
                       steps=steps_run)

        # -- the integrity gate, in a telemetry session -------------------
        tel_dir = os.path.join(root, "tel")
        newest = RES_BATCHES + 1
        with obs.session(obs.TelemetryConfig(
                dir=tel_dir, flight_recorder=False,
                anomaly_detection=False)):
            mgr = CheckpointManager(dir_a, keep_last_n=RES_KEEP,
                                    fault_injector=FaultInjector().inject(
                                        "bitflip", target="disk"))
            mgr.save(a, newest)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                info = restore_latest(c, dir_a)
        if info is None or info.step != RES_BATCHES or c.state.step != \
                RES_BATCHES:
            raise AssertionError(f"restore_latest past the corrupt "
                                 f"newest: {info}")
        if not any("falling back" in str(w.message) for w in caught):
            raise AssertionError("restore_latest gave no fallback warning")
        with open(os.path.join(tel_dir, "metrics.prom")) as f:
            prom = obs.parse_prometheus(f.read())
        if prom.get("ff_checkpoint_restore_fallbacks_total") != 1:
            raise AssertionError(f"metrics: {prom}")
        audit = verify_checkpoint(mgr.step_path(newest))
        if audit["ok"] or len(audit["corrupt"]) != 1 or \
                not audit["corrupt"][0].startswith("params/"):
            raise AssertionError(f"audit of the corrupt newest: {audit}")
        log(f"  integrity: the corrupt newest (step {newest}, "
            f"{audit['corrupt'][0]}) skipped, step {info.step} restored; "
            f"ff_checkpoint_restore_fallbacks_total "
            f"{prom['ff_checkpoint_restore_fallbacks_total']}")
        summary["integrity"] = {
            "corrupt": audit["corrupt"], "restored_step": info.step,
            "fallbacks_total": prom["ff_checkpoint_restore_fallbacks_total"],
            "checkpoint_counters": {k: v for k, v in prom.items()
                                    if k.startswith("ff_checkpoint_")}}

        # -- readings: bytes, save and restore, the guard's overhead ------
        ck = os.path.join(root, "timed")
        save_ms, restore_ms = [], []
        for _ in range(RES_TIMED_IO):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(a, ck)
            save_ms.append(1e3 * (time.perf_counter() - t0))
        for _ in range(RES_TIMED_IO):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_checkpoint(c, ck)
            torch.cuda.synchronize()
            restore_ms.append(1e3 * (time.perf_counter() - t0))
        if states_not_equal(torch, a, c, guard=False):
            raise AssertionError("the timed restore differs from the save")
        summary["checkpoint"] = {
            "state_bytes": prom["ff_checkpoint_bytes"],
            "file_bytes": os.path.getsize(os.path.join(ck, "state.pt")),
            "save_ms_median": float(np.median(save_ms)),
            "restore_ms_median": float(np.median(restore_ms)),
            "save_ms": save_ms, "restore_ms": restore_ms}
        overhead = guard_overhead(torch, a, guard, x, y)
        summary["guard_overhead"] = overhead
        log(f"  checkpoint {summary['checkpoint']['state_bytes']:.0f} B: "
            f"save {summary['checkpoint']['save_ms_median']:.1f} ms, restore "
            f"{summary['checkpoint']['restore_ms_median']:.1f} ms (median "
            f"of {RES_TIMED_IO}); step unguarded "
            f"{overhead['unguarded']['step_ms_median']:.3f} ms, guarded "
            f"{overhead['guarded']['step_ms_median']:.3f} ms (spreads "
            f"{overhead['unguarded']['spread']:.3f}, "
            f"{overhead['guarded']['spread']:.3f}); bound of the guard "
            f"{overhead['bound_ms_function']:.3f} ms, of its passes "
            f"{overhead['bound_ms_passes']:.3f} ms")
        del a, c
        torch.cuda.empty_cache()

        # -- a finding, not a pass criterion: lr 0.01 under the guard -----
        d = build_bert_model(torch)
        skipped = []
        record_each_step(d, lambda st: skipped.append(
            st.guard.consecutive_skips.clone()))
        try:
            text_d = quiet_fit(d, x, y, epochs=RES_DIVERGE_EPOCHS,
                               step_guard=StepGuardConfig())
            outcome = "completed"
        except NonFiniteGradientsError as e:
            # the guard's answer to a run that keeps diverging: recorded
            text_d, outcome = "", f"NonFiniteGradientsError: {e}"
        g = d.state.guard
        skip_steps = [i for i, c in enumerate(skipped) if c.item()]
        summary["lr_0_01"] = {
            "steps_planned": RES_DIVERGE_EPOCHS * RES_BATCHES,
            "steps_run": d.state.step, "outcome": outcome,
            "skipped_steps": skip_steps,
            "total_skips": g.total_skips.item(),
            "loss_scale": g.loss_scale.item(),
            "epoch_lines": epoch_lines(text_d)}
        log(f"  lr 0.01 under the default guard: {outcome}; "
            f"{d.state.step} steps, steps {skip_steps} skipped, scale "
            f"{g.loss_scale.item()}")
        del d
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary



def wgmma_build_report(build):
    """Registers, spill bytes and shared memory of each wgmma kernel
    instance, from ptxas's report in the build log (-Xptxas -v) and the
    sources' own shared-memory layout. ptxas's register count is the
    block's at launch; setmaxnreg then moves the consumers to
    kConsumerRegs and the producer to kProducerRegs (csrc/sm90.cuh).
    Raises if any of them spills."""
    from flexflow_tpu_torch.kernels import attention as ka

    smem = ka.wgmma_smem_bytes()
    dtypes = {"13__nv_bfloat16": "bf16", "6__half": "f16"}
    out = {}
    for src in ("flash_fwd", "flash_bwd"):
        cur = None
        for line in build.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '\w*?wg\d+(flash_\w+?_"
                          r"wgmma_kernel)I(13__nv_bfloat16|6__half)Li(\d+)ELb"
                          r"([01])E", line)
            if m:
                name, dt, d, drop = m.groups()
                cur = f"{name}<{dtypes[dt]}, d={d}, dropout={drop}>"
                out[cur] = {"dynamic_smem_bytes": smem[f"{name}_d{d}"]}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                out[cur].update(stack_bytes=int(m.group(1)),
                                spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers_at_launch"] = int(m.group(1))
                cur = None
    if len(out) != 24:   # 3 kernels x 2 dtypes x 2 head dims x dropout
        raise AssertionError(f"ptxas report names {len(out)} wgmma kernels, "
                             "expected 24")
    spills = {k: v for k, v in out.items()
              if v["spill_store_bytes"] or v["spill_load_bytes"]}
    if spills:
        raise AssertionError(f"wgmma kernels spill: {spills}")
    regs = sorted({v["registers_at_launch"] for v in out.values()})
    log(f"# wgmma kernels: {len(out)} instances, 0 spill bytes, registers "
        f"at launch {regs}, dynamic shared memory "
        f"{sorted(set(smem.values()))} bytes")
    return out


def paged_build_report(build):
    """Registers, spill bytes and static shared memory of each paged-decode
    kernel instance, from ptxas's report in the build log (-Xptxas -v).
    Raises if a cluster instance spills or one is missing (bf16/fp16 x 4,
    8, 16, 32 lanes a row)."""
    dtypes = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    out, cur = {}, None
    for line in build.build_log("paged_decode").splitlines():
        m = re.search(r"Compiling entry function '\w*?paged_decode_(cluster|"
                      r"block)_kernelI(13__nv_bfloat16|6__half|f)(?:Li(\d+)E)?",
                      line)
        if m:
            kind, dt, lanes = m.groups()
            cur = f"{kind}<{dtypes[dt]}" + (f", lanes={lanes}>" if lanes
                                            else ">")
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)),
                            static_smem_bytes=int(sm.group(1)) if sm else 0)
            cur = None
    cluster = {k: v for k, v in out.items() if k.startswith("cluster")}
    if len(cluster) != 8:
        raise AssertionError(f"ptxas report names {sorted(cluster)}, "
                             "expected 8 cluster instances")
    spills = {k: v for k, v in cluster.items()
              if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
    if spills:
        raise AssertionError(f"paged cluster kernels spill: {spills}")
    log("# paged decode kernels: " + "; ".join(
        f"{k} {v.get('registers')} regs, {v.get('static_smem_bytes')} B smem"
        f", spills {v.get('spill_store_bytes')}" for k, v in out.items()))
    return out


def decode_step_profile(torch, model, eager=False):
    """One warm decode step of the serving LM with every slot at
    mid-length (positions 0..MAX_LEN/2 - 1 held, each row's position
    passed per row as the batcher does; caches zero-filled, which moves
    the same bytes as any other contents), traced, beside the host-clock
    time of such a step (best of 5). By default the step replays its
    captured graph and reads the cached bf16 weights; `eager` runs the
    ops one by one, as every step ran before capture (weights cached)."""
    init, step = model.executor.build_decode(SLOTS, MAX_LEN)
    caches = init(model.params)
    t = np.full(SLOTS, MAX_LEN // 2, np.int32)
    tok = np.random.RandomState(2).randint(0, VOCAB, (SLOTS, 1)) \
        .astype(np.int32)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model.params, caches, t, [tok], _eager=eager)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    prof = profile_step(torch, lambda: step(model.params, caches, t, [tok],
                                            _eager=eager))
    fam = prof["by_family_ms"]
    prof.update(step_ms_reading=min(times[2:]), position=MAX_LEN // 2,
                captured=not eager,
                idle_share_host_clock=max(
                    0.0, 1.0 - prof["device_busy_ms"] / min(times[2:])),
                paged_share=fam["paged_decode"] / prof["device_busy_ms"],
                gemm_share=fam["gemm"] / prof["device_busy_ms"])
    log(f"  decode step ({SLOTS} slots at position {MAX_LEN // 2}, "
        f"{'eager' if eager else 'captured'}): warm "
        f"{prof['step_ms_reading']:.3f} ms on the host clock; paged share "
        f"of device busy {prof['paged_share']:.4f}, GEMMs "
        f"{prof['gemm_share']:.4f}, casts {fam['cast']:.4f} ms in "
        f"{prof['events_by_family']['cast']} events, idle share "
        f"{prof['idle_share_host_clock']:.4f} (under the profiler "
        f"{prof['idle_share']:.4f})")
    return prof


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.kernels import build

    smi = gpu_name_and_power()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    t_build = time.perf_counter() - t0
    log(f"# kernels built in {t_build:.1f}s")
    report = {"build_s": t_build, "nvidia_smi": smi,
              "ptxas": {n: build.build_log(n) for n in build.KERNEL_SOURCES}}
    report["wgmma_kernels"] = wgmma_build_report(build)
    report["paged_kernels"] = paged_build_report(build)

    log("# kernel phase")
    torch.manual_seed(0)
    kernels = [check_flash(torch), check_flash_bwd(torch), check_paged(torch)]
    kernels += check_flash_dropout(torch)

    log("# serving phase")
    model = build_model(torch)
    ids = np.random.RandomState(1).randint(0, VOCAB, (SLOTS, MAX_LEN))
    unit_scale_weights(torch, model, ids.astype(np.int32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    summary = serve(torch, model)
    torch.cuda.synchronize()
    serving_counts = dict(build.launch_counts)
    summary["launches"] = serving_counts
    summary["launches_by_path"] = dict(build.path_counts)
    check_wgmma_paths("serving", serving_counts, build.path_counts)
    summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (serving_counts["flash_fwd"] and serving_counts["paged_decode"]):
        raise AssertionError(f"a kernel of the serving path never launched: "
                             f"{serving_counts}")
    paged = {k: summary["launches_by_path"][k] for k in (
        "paged_decode_cluster", "paged_decode_block")}
    if paged != {"paged_decode_cluster": serving_counts["paged_decode"],
                 "paged_decode_block": 0}:
        raise AssertionError(f"serving: paged launches by path {paged}, "
                             "expected all on cluster")
    summary["decode_step_profile"] = decode_step_profile(torch, model)
    summary["decode_step_profile_eager"] = decode_step_profile(
        torch, model, eager=True)
    del model
    torch.cuda.empty_cache()

    log("# training phase")
    training = train(torch)
    torch.cuda.empty_cache()

    log("# training scan phase")
    scan = train_scan(torch)
    torch.cuda.empty_cache()

    log("# bert phase")
    bert_summary = bert(torch)
    torch.cuda.empty_cache()

    log("# bert scan and remat phase")
    bscan = bert_scan(torch)
    torch.cuda.empty_cache()

    log("# cnn phase: the bootcamp's AlexNet")
    alex = alexnet(torch)
    torch.cuda.empty_cache()

    log("# cnn phase: ResNeXt-50")
    rx = resnext(torch)
    torch.cuda.empty_cache()

    log("# moe phase: the MoE Transformer")
    moe_summary = moe(torch)
    torch.cuda.empty_cache()

    log("# dlrm phase")
    dl = dlrm(torch)
    torch.cuda.empty_cache()

    log("# inception phase: Inception-v3")
    inc = inception(torch)
    torch.cuda.empty_cache()

    log("# zoo phase: CANDLE-Uno, MLP_Unify, XDL")
    zo = zoo(torch)
    torch.cuda.empty_cache()

    log("# longctx phase: the long-context Transformer at 32768 positions")
    lc = longctx(torch)
    torch.cuda.empty_cache()

    log("# nmt phase: the LSTM seq2seq model")
    nm = nmt(torch)
    torch.cuda.empty_cache()

    log("# fusion phase: the flagship Transformer with --fusion")
    fu = fusion(torch)
    torch.cuda.empty_cache()

    log("# search phase: the Unity search, operators measured on the card")
    se = search(torch)
    torch.cuda.empty_cache()

    log("# seq2seq phase: encoder-decoder serving, Transformer (big)")
    s2 = seq2seq(torch)
    torch.cuda.empty_cache()

    log("# resilience phase: checkpoints and the resilient fit, BERT-base")
    rs = resilience(torch)

    # the CNN and zoo paths run none of the three kernels (cuDNN
    # convolutions and cuBLAS products, as the JAX package's are XLA's);
    # their counts stand in the table as 0. The MoE Transformer's
    # attention runs both flash kernels.
    by_phase = {"serving": serving_counts, "training": training["launches"],
                "training_scan": scan["launches"],
                "bert": bert_summary["launches"],
                "bert_scan": bscan["launches"],
                "alexnet": alex["launches"], "resnext": rx["launches"],
                "moe": moe_summary["launches"], "dlrm": dl["launches"],
                "inception": inc["launches"], "zoo": zo["launches"],
                "longctx": lc["launches"], "nmt": nm["launches"],
                "fusion": fu["launches"], "search": se["launches"],
                "seq2seq": s2["launches"], "resilience": rs["launches"]}
    # rows 1 and 2 at the long-context model's shape (bound by operations)
    for k in kernels[:2]:
        k["long_context_shape"] = lc["flash_long_shape"][k["name"]]
    # rows 1 and 3 at the seq2seq phase's shapes
    for k in kernels:
        if k["name"] in s2["kernels"]:
            k["seq2seq_shape"] = s2["kernels"][k["name"]]
    for k in kernels:
        k["launches_by_phase"] = {p: c.get(k["name"], 0)
                                  for p, c in by_phase.items()}
        k["launches"] = sum(k["launches_by_phase"].values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']} launched on no path: {by_phase}")

    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_phase", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "wmma_ms", "block_ms", "path",
            "long_context_shape", "seq2seq_shape")
    line = {"kernels": [{k: kr[k] for k in keys if k in kr}
                        for kr in kernels]}
    for row in line["kernels"]:
        if "wmma_ms" in row:   # every main-path launch took the wgmma path
            row["path"] = "wgmma"
    report.update(kernels=kernels, serving=summary, training=training,
                  training_scan=scan, bert=bert_summary, bert_scan=bscan,
                  alexnet=alex, resnext=rx, moe=moe_summary, dlrm=dl,
                  inception=inc, zoo=zo, longctx=lc, nmt=nm, fusion=fu,
                  search=se, seq2seq=s2, resilience=rs)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"serving": summary}))
    log(json.dumps({"training": training}))
    log(json.dumps({"training_scan": scan}))
    log(json.dumps({"bert": bert_summary}))
    log(json.dumps({"bert_scan": bscan}))
    log(smi + " " + json.dumps({"cnn": {
        k: {"samples_per_s_stepwise":
            v["abba"]["stepwise"]["samples_per_s_median"],
            "samples_per_s_scan": v["abba"]["scan"]["samples_per_s_median"],
            "peak_mem_gb": v["peak_mem_gb"],
            "step_idle_share": v["step_profile"]["idle_share"],
            "scan_idle_share": v["scan_profile"]["idle_share_host_clock"],
            "scan_replay_ms_a_step":
            v["scan_profile"]["replay_device_ms_per_step"],
            "scan_idle_share_replay": v["scan_profile"]["idle_share_replay"],
            "step_ms_by_family": v["step_profile"]["by_family_ms"]}
        for k, v in (("alexnet", alex), ("resnext50", rx))}}))
    log(json.dumps({"alexnet": alex}))
    log(json.dumps({"resnext": rx}))

    def readings(v):
        return {"samples_per_s_stepwise":
                v["abba"]["stepwise"]["samples_per_s_median"],
                "samples_per_s_scan": v["abba"]["scan"]["samples_per_s_median"],
                "peak_mem_gb": v["peak_mem_gb"],
                "step_idle_share": v["step_profile"]["idle_share"],
                "scan_idle_share_replay":
                v["scan_profile"]["idle_share_replay"],
                "scan_replay_ms_a_step":
                v["scan_profile"]["replay_device_ms_per_step"],
                "step_ms_by_family": v["step_profile"]["by_family_ms"]}

    log(smi + " " + json.dumps({"zoo_models": {
        k: readings(v) for k, v in (
            ("moe_transformer", moe_summary), ("dlrm", dl),
            ("inception_v3", inc), ("candle_uno", zo["candle_uno"]),
            ("mlp_unify", zo["mlp_unify"]), ("xdl", zo["xdl"]))}}))
    log(json.dumps({"moe": moe_summary}))
    log(json.dumps({"dlrm": dl}))
    log(json.dumps({"inception": inc}))
    log(json.dumps({"zoo": zo}))
    lcs = lc["flash_long_shape"]
    log(smi + " " + json.dumps({"longctx_nmt_fusion": {
        "longctx": dict(readings(lc), losses_one_batch=lc["losses_one_batch"],
                        oracle_worst=lc["oracle"]["worst_grad_rel_err"],
                        flash_fwd_ms=lcs["flash_fwd"]["ms"],
                        flash_fwd_bound_ms=lcs["flash_fwd"]["bound_ms"],
                        flash_fwd_sdpa_ms=lcs["flash_fwd"]["library_ms"],
                        flash_bwd_ms=lcs["flash_bwd"]["ms"],
                        flash_bwd_bound_ms=lcs["flash_bwd"]["bound_ms"],
                        flash_bwd_sdpa_ms=lcs["flash_bwd"]["library_ms"]),
        "nmt": dict(readings(nm), epoch_ce=nm["epoch_ce"],
                    oracle_worst=nm["oracle"]["worst_grad_rel_err"]),
        "fusion": {"fused_ops": fu["fused_ops"],
                   "samples_per_s_unfused":
                   fu["abba"]["unfused"]["samples_per_s_median"],
                   "samples_per_s_fused":
                   fu["abba"]["fused"]["samples_per_s_median"]}}}))
    log(json.dumps({"longctx": lc}))
    log(json.dumps({"nmt": nm}))
    log(json.dumps({"fusion": fu}))

    def searched(r):
        return {k: r[k] for k in (
            "search_s", "compile_s", "measured_keys", "searched_cost",
            "winner_view_dims", "by_op_type",
            "measurement_launches_by_path", "fallbacks")} | {
            "trained_vs_unsearched": r["training"]["weights_vs_unsearched"],
            "keeps_lowering_ops": r["training"]["keeps_lowering_ops"]}

    log(smi + " " + json.dumps({"search": {
        "x1": searched(se["x1"]),
        f"x{SEARCH_WORKERS}": dict(searched(se[f"x{SEARCH_WORKERS}"]),
                                   exported=se[f"x{SEARCH_WORKERS}"][
                                       "exported"]),
        "phase_s": se["phase_s"]}}))
    log(smi + " " + json.dumps({"seq2seq": s2}))
    log(smi + " " + json.dumps({"resilience": rs}))
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
