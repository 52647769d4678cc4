#!/usr/bin/env python3
"""Drive the PyTorch port (dana_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--parallel_only]

Run from the repository root.  Phases, each of which fails the run:
  1. device: a CUDA card must be present; prints its name and power
     limit, the torch / CUDA versions and the float32 (TF32) flags;
  2. build: every kernel of the serving and training paths is compiled
     by nvcc from dana_tpu_torch/ops/csrc, one nvcc per source, all at
     once;
  3. kernels: each kernel's wrapper is held against its plain PyTorch
     version on the card (|kernel - plain| <= 1e-4 + 1e-4 |plain|: both
     sum float32 products in different orders) at the shapes the serving
     and training paths give it plus edge shapes, and timed with CUDA
     events beside its plain version, a library yardstick and its bound
     (the CISA kernels' at the 3xTF32 tensor-core rate, with their
     achieved TFLOP/s; the RoIAlign kernels' with their GB/s, the bytes
     they read through L2 by the taps they keep, and their time without
     the rois that span the whole map);
     the backward passes of the CISA and RoIAlign autograd Functions are
     held against autograd of the plain versions; K1 at its serving RPN
     site and K2 are also held (and timed) at the other four query
     buckets' shapes (K1's RoI site has one shape at every bucket), and
     K2 against K3 on the same rois' axis weights at
     K2_TOL (the two share one pooling body and, since the plain weights
     divide as the kernel does, their weights); K1's four sites, K2 and K3
     are held and timed again on VGG16's 512 channels, and K1's serving
     sites and training RPN site, K2 (1000 rois an image) and K3 on the
     --ls canvas (LS_HW), which --ls gives both CLIs; K1 float32 and
     K1-bf16 at both serving sites at the N-way evaluation's 2 and 5 shots
     (MULTIWAY_SHOTS), where K1 takes other tile plans.  The bf16 kernels of
     the precision recipe (phase 10) on bf16 inputs: K1 at its two serving
     sites on 1024 and 512 channels and at edge shapes, K4 (K1's bf16
     kernel at S = 1) and K2 on 1024 and 512 channels (the rois rounded to
     bf16 as the model rounds them), each held against its plain version
     at |kernel - plain| <= BF16_ULP * max|plain| (one bf16 ulp at the
     output's scale) and timed beside it, SDPA in bf16 for K1 and K4, and
     the bound (K1 and K4 at the bf16 tensor-core rate, K2 its bytes);
     K1-bf16's and K4-bf16's two phases (the probabilities into a bf16
     scratch, then one product over the shots' keys) are timed apart and
     printed beside the earlier mma.sync kernel's time
     (MMA_SYNC_CISA_BF16_MS) with TFLOP/s and GB/s, after the kernel's
     ptxas register and spill report; K2-bf16 is also held and timed at
     the other four query buckets and on the --ls canvas (1000 rois an
     image), each time with its time without the whole-map rois, its
     modelled L2 bytes (each roi's kept taps once, `roi_tap_extent`,
     beside the row-pooling body's rule) and the tensor-core TFLOP/s of its
     padded product, beside the row-pooling kernel's time at the first
     bucket (ROW_POOLING_K2_BF16_MS), after roi_align.cu's ptxas report.
     The bf16 training step's kernels at its shapes: K1-bf16 at the
     training RPN and RoI sites, and K2-bf16 on TRAIN_BATCH maps with 128
     rois an image drawn like the sampler's (`training_rois`: fg near a gt
     box, bg anywhere, one whole-map roi), each held at one bf16 ulp and
     timed as above; the bf16 RoIAlign's backward on the card (one bf16
     product over the images, `roi_align_combine_backward`) held at one
     bf16 ulp against the same formula summed in float32 and timed beside
     it and its bound.  The NMS kernel (csrc/nms.cu; it replaces no Pallas
     kernel) is held after phases 4 and 5, on the sorted boxes they gave
     it (recorded in request 0 and step 0): serving proposals (B 8, N
     6000, M 300, IoU 0.7), the detection postprocess (B 8, N 300, M 100,
     IoU 0.3, score > 0.05) and training proposals (B 4, N 12000, M 2000),
     each on that data and on adversarial cases at its shape (every box
     twice: IoU exactly 1; IoUs exactly float32(thr); no valid box; M
     reached in the first 64 boxes; N cut to no multiple of 64) and on
     the whole NMS with every score tied: positions and masks equal to the
     plain version's, timed beside it and its bound (the IoUs the data
     needs at the float32 rate, or its bytes).  The trunk's BN-act
     epilogue (csrc/bn_act.cu; it replaces no Pallas kernel) at a
     request's stem, layer1, layer3 and layer4 shapes in float32 channels
     last, and its backward at layer3's: equal to the plain chain bit for
     bit, timed beside it and its bound (its bytes);
  4. serving: the DAnA ResNet-50 2-way 3-shot detector with random
     weights from --seed serves REQUESTS requests of BATCH uint8
     608x1024 queries against two classes whose 320px supports were
     encoded once.  The launch counters are zeroed just before and read
     just after: 2 CISA, 1 RoIAlign and 2 NMS launches a request, and the
     single-group CISA (no site on this path or the next) never; NMS
     synchronises the host no time (the counter table's `host_syncs.nms`
     0).  The
     outputs must be finite and of the right shapes, and the first
     request, served again with the plain versions in place of the
     kernels (and the kernel path's proposals), must agree: the RPN's
     scores and deltas, the R-CNN head's outputs and the detections
     (tie-aware matching);
  5. training: a Trainer on the same detector takes STEPS SGD steps on
     seeded episodes of TRAIN_BATCH uint8 608x1024 queries, 1-5 gt boxes
     each and 2x3 supports of 320px.  The counters are zeroed just before
     and read just after: 3 CISA, 1 RoIAlign-from-weights and 1 NMS
     launches a step, no single-group CISA launch, no NMS host sync.  Losses must be finite, no step
     skipped, fg rois sampled, every trainable parameter moved and every
     frozen one unchanged.  Step 0,
     run again on the plain versions from the same weights, draws and
     proposals, must give the same losses (1e-4 relative) and gradients
     (GRAD_RTOL of each parameter's gradient norm);
  7. the training CLI (run before phase 6, which serves its checkpoint):
     `dana_tpu_torch.train.main` trains the same detector at the CLI's
     full default config (cfgs/res50.yml values, --ascale 4: 12 anchors,
     600 px queries, 12000/2000 proposals, 128 rois and 256 anchors an
     image) on synth_train (60 images of 480x640, all in the 608x1024
     bucket, written into a temporary DANA_SYNTH_ROOT by the port's
     generator) with --way 2 --shot 3 --bs 4 --epochs 2 --nw 8, random
     weights from --seed; then a second run resumes from the epoch-1
     checkpoint (--r) and trains epoch 2 again.  The counters are zeroed
     just before the two runs and read just after: 3 CISA and 1
     RoIAlign-from-weights launches a step, none of the others.  Every
     loss must be finite and no step skipped; what the resumed run's first
     step starts from (parameters, momentum buffers, generator state, lr,
     the batch) must equal, bit for bit, what the straight run's first
     step of epoch 2 started from.  The two runs' epoch-2 losses are
     printed, not compared (cuDNN's backward is not deterministic), with
     the steady step time beside phase 5's, episodes/s, the seconds the
     loop waited for batches and the peak memory;
  6. the dataset CLI: `dana_tpu_torch.inference.main` evaluates the
     synth_test split (20 images, beside synth_train) with --way 2 --shot
     3 --bs 8 at the full default config (cfgs/res50.yml values, --ascale
     4: 12 anchors, 600 px queries, 6000/300 proposals), serving the
     checkpoint phase 7 wrote.  The counters are zeroed just before and
     read just after: 2 CISA and 1 RoIAlign launches a chunk, none of the
     training kernels.  Every image's target-class cell of all_boxes must
     hold finite detections and COCOeval must return 12 finite stats;
     img/s, the host-side timing and the stats are printed (AP after two
     epochs on 60 images is not judged);
  8. the other frameworks (models/frameworks.py) and cisa, each the
     2-way 3-shot ResNet-50 detector with random weights from --seed
     (`get_model`): FW_REQUESTS requests of BATCH uint8 608x1024 queries
     through `Predictor.predict` (cisa from its support cache, FSOD, Meta
     R-CNN and FGN with each request's BATCH x 3 supports of 320 px;
     Faster R-CNN, which has no serving path, through its eval forward),
     and FW_STEPS Trainer steps of TRAIN_BATCH episodes (12000/2000
     proposals; Meta R-CNN's with every class's gt beside the episode's).
     The counters are zeroed just before each path and read just after:
     RoIAlign once a request and RoIAlign-from-weights once a step for
     every framework, CISA only for cisa (2 a request, 3 a step), the
     single-group CISA never.  Request 0 and step 0 are run again on the
     plain versions with the kernel path's proposals (and draws), held as
     in phases 4 and 5 (Faster R-CNN: its RPN and head outputs only).
     Then the two CLIs with --net meta: one epoch on synth_train, and its
     checkpoint served over synth_test (eps/s, img/s, the timing line and
     AP printed, AP not judged).  Each path's latency or step time and
     peak memory are printed with the card's name and power limit;
  9. the other trunks and pooling modes (SLICE9): the 2-way 3-shot DAnA
     on ResNet-101 and on VGG16 serves REQUESTS requests and takes STEPS
     steps, on ResNet-152 it serves, and on ResNet-50 with POOLING_MODE
     pool and crop it does both, each as phases 4 and 5 drive the main
     path (counters zeroed around each path: 2 K1 and 1 K2 a request, 3 K1
     and 1 K3 a step in align mode, no K2 or K3 in pool and crop mode;
     request 0 and step 0 against the plain versions; every trainable
     parameter moved, VGG16's whole trunk included).  Then the two CLIs
     (SLICE9_CLI): --backbone vgg16 --set POOLING_MODE pool trains one
     epoch of synth_train, and the dataset CLI serves that checkpoint over
     synth_test with no --set, pooling with RoIPool, the mode the
     checkpoint records; --backbone res101 --ls does the same at 800 px;
 10. precision (PRECISION): phase 4's detector with TPU.COMPUTE_DTYPE
     bfloat16 in three settings, the default recipe (bf16 attention,
     float32 head), pure bf16 and a float32 attention island, serves
     REQUESTS requests each as phase 4 does (counters zeroed around each
     path: 2 K1 a request in the attention dtype, 1 K2 in bf16; request 0
     against the plain versions on the kernel path's proposals, its RPN
     scores and deltas, head outputs and detection scores within
     PATH_TOL_BF16, boxes at phase 4's tolerance), with its steady times
     and peak memory beside phase 4's float32; the bf16 trunk is timed in
     channels_last and in contiguous NCHW; then the dataset CLI serves
     phase 7's checkpoint over synth_test in the default recipe (--set
     TPU.COMPUTE_DTYPE bfloat16: 2 bf16 K1 and 1 bf16 K2 a chunk), its AP
     printed beside phase 6's float32 AP, not judged;
 11. bf16 training: a Trainer on phase 5's detector takes STEPS steps in
     the default recipe and STEPS in pure bf16 (TRAIN_RECIPES) on phase 5's
     episodes (counters zeroed around each path: 3 bf16 K1 and 1 bf16 K2 a
     step, no float32 kernel), held as phase 5 holds its steps but for the
     tolerances: step 0 on the plain versions within PATH_TOL_BF16
     (absolute plus relative) on the losses and GRAD_TOL_BF16 of the
     step's gradient norm on each parameter's gradient (the reason beside
     it), its steady step time and peak memory printed beside phase 5's;
     FSOD, Meta R-CNN, FGN, cisa and Faster R-CNN take FW_STEPS steps each
     in the default recipe, held as phase 8 holds them at the same bf16
     tolerances; DAnA in pool and in crop mode serves one request and
     takes one step in the default recipe against the plain path; then the
     training CLI trains one epoch of synth_train in the default recipe
     (3 bf16 K1 and 1 bf16 K2 a step) and the dataset CLI serves its
     checkpoint over synth_test in the default recipe and in pure bf16,
     each AP printed beside phase 6's float32 AP, not judged;
 12. the N-way evaluation, Pascal VOC, product attention and remat
     (SLICE14): (a) `dana_tpu_torch.multiway_eval` serves phase 7's
     checkpoint over synth_test 5-way 2-shot and 5-way 5-shot (BASELINE
     config #4), each image's ways one request (counters zeroed around
     each run: 2 K1 and 1 K2 an image), img/s and AP printed (not judged),
     then request 0 of each shot count at full serving size (one 608x1024
     query as 5 rows, 6000 / 300, random weights from --seed) in float32
     and in the default recipe against the plain path (phases 4 and 10's
     tolerances); (b) the training CLI with its default --dataset
     pascal_voc trains one epoch on a VOC2007 devkit written from the synth
     scenes under a temporary DATA_DIR (3 K1 and 1 K3 a step), and the
     dataset CLI serves its checkpoint over voc_2007_test (2 K1 and 1 K2 a
     chunk; the VOC mean AP printed, not judged); (c) DAnA with product
     attention serves two requests and takes a step against the plain
     path, as phases 4 and 5 hold theirs; (d) phase 5's first step with
     TPU.REMAT_BACKBONE True against without: equal losses, gradients
     within REMAT_TOL of the step's gradient norm, both peak memories
     printed;
 13. parallelism (dana_tpu_torch/parallel), on every card present, or on
     cuda:0 named twice when there is one: (a) phase 4's predictor on a
     --mGPUs grid (every card as data rows), tp=2 and sp=2 serves REQUESTS
     requests, timed beside the unsharded predictor's in this call, peak
     memory per device, K1 and K2 counted by device (2 and 1 a request on
     each data row's first device), request 0 against the unsharded one on
     its proposals at phase 4's tolerances (detections tie-aware); (b)
     phase 5's first batch as a data-parallel step of 2 ranks
     (tools/torch_dist_step.py; nccl on two cards, gloo when they share
     one) whose kernels build cold in a fresh DANA_BUILD_DIR, in float32
     (3 K1 and 1 K3 a rank) and in the default recipe (3 K1-bf16 and 1
     K2-bf16 a rank), each held against the one-process step (losses at
     LOSS_RTOL / PATH_TOL_BF16, parameters at GRAD_RTOL / GRAD_TOL_BF16 of
     the step's update) and timed by rank beside it; (c) the training CLI
     with --mGPUs --dist as 2 processes for an epoch of synth_test, then
     the dataset CLI with --dist as 2 processes on its checkpoint against
     the one-process CLI (detections tie-aware), launches counted by rank
     (each rank is this script with --cli_rank); (d) phase 4's detector
     quantized (scope 'tail' and 'all') on the --mGPUs grid, and 'all' at
     sp=2, serves REQUESTS requests timed beside the one-device int8
     predictor's in this call and (a)'s float32 grid, K1, K2, NMS and the
     int8 products (`torch._int_mm`) counted by device, request 0 against
     the one-device int8 request: every int8 conv's scale on every row
     printed beside the one-device scale (within SCALE_RTOL), the data rows
     at phase 4's tolerances on the one-device request's proposals
     (detections tie-aware), sp bit for bit.  --parallel_only runs
     phases 1, 2 and 13 alone (run it on a host with four cards);
 14. int8 serving (INT8): phase 4's detector quantized by
     dana_tpu_torch/quant.py serves REQUESTS requests in three settings,
     scope 'tail' in float32, scope 'tail' in the default recipe and scope
     'all' in float32 (counters zeroed around each path: 2 K1 a request,
     K2 once on a float32 map, on the recipe's bf16 map the int8 RoIAlign
     once and K2-bf16 never, 10 int8 convs a request under 'tail' and 53
     under 'all', plus 43 a class at `encode_supports`, and one
     `torch._int_mm` for each conv and each image of the int8 RoIAlign);
     request 0 against the plain path (the kernels' plain versions and the
     int8 products as exact float64 ones, on the kernel path's proposals)
     at phase 4's and phase 10's tolerances; the distance of its
     detections from phase 4's float32 ones, and its request ms and peak
     memory beside phases 4 and 10, printed; the identity BatchNorm exact
     on the card; layer4's ten convs at the serving shapes as `_int_mm`
     products, whole int8 convs and cuDNN float32 / bf16 convs, timed
     beside the int8 bound (INT8_OPS_PER_S), and layer4 whole in each;
     then the dataset CLI with --set TPU.QUANT_INT8 True serves phase 7's
     checkpoint over synth_test (10 int8 convs and 1 K2 a chunk), printing
     the JAX CLI's line, its AP beside phase 6's (not judged);
 15. serving export (dana_tpu_torch/serve.py): phase 4's float32 detector
     exported at the five query buckets plus its support encoder, and at
     608x1024 in the default recipe and under int8 'tail' (export seconds,
     artifact bytes against the weights' bytes; a file at 10% of the
     weights fails), then the float32 and int8 'tail' ones again by a
     process that sees no card (this script with --export_child, under
     CUDA_VISIBLE_DEVICES=''; its programs must name cuda:0 only); every
     artifact served in
     one fresh process (this script with --serve_child) that imports
     dana_tpu_torch.serve and not the model code, the weights passed as an
     argument: REQUESTS requests at 608x1024 and one at each other bucket,
     one request of each other artifact, and a second seed's weights
     through the first artifact, each against the live Predictor on the
     same support features and queries (detections tie-aware at phase 4's
     tolerance, phase 10's in the recipe; whether bit for bit is printed;
     the card-less exports must be), the card-less float32 artifact bit
     for bit against the one exported on this host on request 0, the
     encoder artifact against the live encoder at 1e-4, launches counted
     in that process (2 K1, 1 K2 and 2 NMS a request, in the recipe's
     dtypes, and 10 int8 products under int8; no NMS host sync), request
     times (after an untimed first call) beside the live predictor's.
 16. the space-to-depth stem (TPU.STEM_S2D; run after phase 14, inside its
     synth root, as its CLI part serves phase 7's checkpoint): (a) phase
     4's detector with its supports packed (data/blob.py `s2d_pack`, [6,
     163, 163, 12]) serves REQUESTS requests of uint8 queries packed with
     the rounded means as their border ([8, 307, 515, 12]) as phase 4
     does (K1 2, K2 1, NMS 2 a request, no NMS host sync; request 0
     against the plain versions), then one request of float queries
     through both stems: the trunk's features and the RPN's scores and
     deltas within 1e-4 + 1e-4 |x|, the heads on the direct path's
     proposals within 1e-4, the detections on them tie-aware; (b) conv1
     direct, on the packing and on the packing zero-padded to 16 channels,
     in float32 and bf16 channels_last, by CUDA events beside its bound;
     requests of both stems in float32 and the default recipe, alternating;
     the host's pack and mean subtraction of a batch of 8, native against
     numpy, on one thread and the loader's threads; (c) phase 5's steps on
     packed episodes (K1 3, K3 1, NMS 1 a step; step 0 against the plain
     versions; conv1 frozen); (d) int8 'all' on packed queries (53
     `_int_mm` a request, conv1's included) against the plain path; (e)
     the s2d export of the 608x1024 bucket and the encoder, served in
     this process bit for bit against the live port; (f) the dataset CLI
     with --set TPU.STEM_S2D True on phase 7's checkpoint, its img/s,
     assembly thread-seconds and stats beside phase 6's.
Every phase that counts launches counts NMS too (the proposals, and the
postprocess of a served request or a CLI chunk).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_TC_FLOP_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
# K1 and K4 take each float32 product as three TF32 products (3xTF32)
CISA_FLOP_PER_S = TF32_TC_FLOP_PER_S / 3
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
TOL = 1e-4
# a bf16 kernel against its plain version on the same bf16 inputs: one bf16
# ulp at the output's scale, BF16_ULP * max|plain| (float32 sums in another
# order can move a value across a rounding boundary)
BF16_ULP = 2.0 ** -7
# phase 10: the bf16 kernel path against the plain path (RPN scores and
# deltas, head outputs, detection scores), absolute
PATH_TOL_BF16 = 1e-2
# K2 against K3 on the same rois' weights: one pooling body, weights that
# differ only in the order each entry sums its samples
K2_TOL = 1e-6
ROI_ATOL = 2e-3               # px: a proposal counted as moved (ROADMAP)
DEV = torch.device('cuda', 0)
BOX_ATOL = 1e-3               # px, detections of a unique score
QUERY_HW = (608, 1024)        # first query canvas bucket
# the other query canvases the loaders emit (TPU.SIZE_BUCKETS)
OTHER_BUCKETS = ((1024, 608), (704, 704), (608, 1216), (1216, 608))
SUPPORT_HW = 320
# the --ls canvas: synth's 480x640 images at 800 px (800x1067), snapped up
# to a multiple of 64; 1000 proposals an image (cfgs/res101_ls.yml)
LS_HW = (832, 1088)
LS_POST_NMS = 1000
VGG_C = 512                   # VGG16's base channels
BATCH = 8                     # queries per request
REQUESTS = 3
TRAIN_BATCH = 4               # episodes per training step
STEPS = 3
MAX_GT = 20                   # gt slots per query (1-5 boxes filled)
# float32 sums in another order in the kernel and plain forwards move a
# step's gradients by about 1e-6 of their norm; the mined background rois
# of the R-CNN loss are picked by rank, so a near tie could flip a pick
GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-4
# phase 11: a bf16 step's gradients, kernel path against plain path, per
# parameter, as a share of the norm of the step's whole compared gradient
# (attention, RPN and head parameters), not of the parameter's own norm.
# In bf16 the attention sites' q, k and unary gradients are sums whose
# terms cancel but for probability gradients rounded to bf16 (JAX's VJP
# rounds them so), so a one-ulp difference in a few of K1's outputs moves
# them by far more than an ulp of their own norm: on the CPU (DAnA res50,
# 2 episodes of 320x512), one ulp added to 0.05% of K1's outputs moved
# rpn_adapt_q_layer.weight's gradient by 3.2% (default recipe) to 4.4%
# (pure bf16) of its own norm and output_score_layer.linear1's by 1.0% in
# pure bf16, but no parameter's by more than 5.6e-3 of the step's norm
# (1% of the outputs: 3.3e-3).  A few bf16 ulps (2**-7 = 7.8e-3) of that
# norm: 2e-2.
GRAD_TOL_BF16 = 2e-2
# phase 12: at random init product attention squares the trunk's features
# (the RPN's input reaches 2475 on a 320x512 query where concat's reaches
# 52), so its RPN deltas reach 129 (concat's 7) and K1's float32 last bits,
# 1e-6 of its output, move a delta by 3.3e-4, past phase 4's 1e-4 + 1e-4
# |delta| near the zero crossings.  The product detector's RPN conv and
# R-CNN transform are scaled by PRODUCT_SCALE, which gives its deltas
# concat's magnitude (mean 0.94 against 1.70) and the same 1e-6 of K1's
# output moves them 1.1e-5 (concat: 3.2e-5; a CPU replay with K1's output
# perturbed)
PRODUCT_SCALE = 1.0 / 32
# phase 12: a step with TPU.REMAT_BACKBONE against one without, as a share
# of the step's gradient norm: the backward recomputes the same forward, so
# the gradients are expected bit for bit, but cuDNN's backward kernels are
# not deterministic on the card
REMAT_TOL = 1e-6


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=2):
    """Mean ms per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def cisa_site(fn, plain, library, nbytes, flops):
    """Times of a CISA kernel site beside its plain version and library
    yardstick; its bound at the 3xTF32 tensor-core rate, and at the
    float32 rate outside the tensor cores for comparison."""
    b_ms, b_by = bound_ms(nbytes, flops, CISA_FLOP_PER_S)
    ms = cuda_ms(fn, 10)
    return dict(ms=ms, plain_ms=cuda_ms(plain, 5),
                library_ms=cuda_ms(library, 5), bound_ms=b_ms,
                bound_by=b_by, bound_rate='3xTF32 tensor cores',
                simt_bound_ms=bound_ms(nbytes, flops)[0],
                tflop_per_s=flops / ms / 1e9, flops=flops, bytes=nbytes)


def check_close(name, got, want, tol=TOL):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all():
        fail(f'{name}: kernel output is not finite')
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f'{name}: kernel disagrees with its plain version '
             f'(max |err| {err:.3e}, tolerance {tol:g})')
    return err


def launch_counters():
    """{kernel name: its key in the counter table (utils/trace.py)}: a
    kernel's float32 launches are `<op>.float32`, its bf16 ones
    `<op>.bfloat16`.  Three count int8 serving's work (no hand kernel;
    phase 14): the int8 convs run, the int8 RoIAlign's calls and the
    `torch._int_mm` products that carry both.  `nms` counts the NMS
    kernel's launches (the op's CUDA implementation)."""
    return {'cisa_shots': 'cisa_shots.float32',
            'roi_align_fwd': 'roi_align.float32',
            'roi_align_pw': 'roi_align_pw.float32',
            'cisa_attention': 'cisa_attention.float32',
            'cisa_shots_bf16': 'cisa_shots.bfloat16',
            'roi_align_fwd_bf16': 'roi_align.bfloat16',
            'cisa_attention_bf16': 'cisa_attention.bfloat16',
            'int8_conv': 'dynamic_int8_conv.runs',
            'roi_align_int8': 'roi_align_int8.runs',
            'int_mm': 'int8_matmul.int8',
            'nms': 'nms.float32'}


# the counter table when the counters were last zeroed
_ZERO = collections.Counter()


def zero_launches():
    """Zero the launch counters and NMS's host syncs (read from here on as
    the table's growth)."""
    from dana_tpu_torch.utils import trace
    _ZERO.clear()
    _ZERO.update(trace.counts())


def _since_zero():
    from dana_tpu_torch.utils import trace
    now = trace.counts()
    return {k: now[k] - _ZERO[k] for k in set(now) | set(_ZERO)}


def read_launches():
    since = _since_zero()
    return {name: since.get(key, 0)
            for name, key in launch_counters().items()}


def nms_syncs():
    """NMS's host syncs since `zero_launches` (its plain version's loop
    flags; the kernel syncs none)."""
    return _since_zero().get('host_syncs.nms', 0)


def launch_counts(**counts):
    """Every kernel's launches: `counts`, and 0 for the kernels not named."""
    return {name: counts.get(name, 0) for name in launch_counters()}


# ---------------------------------------------------------------- phase 3

def cisa_library(q, k, v, u, scale, gamma):
    """K1's yardstick: SDPA over the shots as heads, plus the
    query-independent unary term, then the shot mean (timed here; the
    port never calls it)."""
    import torch.nn.functional as F
    o = F.scaled_dot_product_attention(
        q[:, None].expand(-1, k.shape[1], -1, -1), k, v, scale=scale)
    return (o + gamma * (u[:, :, None, :] @ v)).mean(1)


# the shot counts of the N-way evaluation (BASELINE config #4: 5-way 2-shot
# and 5-way 5-shot), at which K1 takes tile plans the 3-shot main path does
# not reach
MULTIWAY_SHOTS = (2, 5)


def multiway_cisa_cases(nq_rpn, ns_rpn, nq_roi, ns_roi):
    """K1's two serving sites at each MULTIWAY_SHOTS shot count, BATCH
    groups: {'rpn_s2': (G, S, Nq, Ns, D, C), ...}."""
    return {f'{site}_s{s}': (BATCH, s, nq, ns, 256, 1024)
            for s in MULTIWAY_SHOTS
            for site, nq, ns in (('rpn', nq_rpn, ns_rpn),
                                 ('roi', nq_roi, ns_roi))}


def check_cisa(dev, gen):
    from dana_tpu_torch.ops.cisa_attention import (
        cisa_attention_shots, cisa_attention_shots_plain)
    from dana_tpu_torch.utils import config as cfg
    library = cisa_library

    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    lh, lw = (s // cfg.FEAT_STRIDE for s in LS_HW)
    ns_rpn = (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    bins = cfg.POOLING_SIZE ** 2
    r_test, r_train = cfg.TEST_RPN_POST_NMS_TOP_N, cfg.TRAIN_BATCH_SIZE
    # (G, S, Nq, Ns, D, C): the two serving-path sites of a request, the
    # training step's (its RoI site runs twice), the same on VGG16's 512
    # channels, the serving sites and the training RPN site on the --ls
    # canvas (the training RoI site's shape does not depend on the
    # canvas), then edge shapes
    cases = {'rpn': (BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'roi': (BATCH, 3, r_test * bins, bins, 256, 1024),
             'train_rpn': (TRAIN_BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'train_roi': (TRAIN_BATCH, 3, r_train * bins, bins, 256, 1024),
             'rpn_c512': (BATCH, 3, fh * fw, ns_rpn, 256, VGG_C),
             'roi_c512': (BATCH, 3, r_test * bins, bins, 256, VGG_C),
             'train_rpn_c512': (TRAIN_BATCH, 3, fh * fw, ns_rpn, 256, VGG_C),
             'train_roi_c512': (TRAIN_BATCH, 3, r_train * bins, bins, 256,
                                VGG_C),
             'rpn_ls': (BATCH, 3, lh * lw, ns_rpn, 256, 1024),
             'roi_ls': (BATCH, 3, LS_POST_NMS * bins, bins, 256, 1024),
             'train_rpn_ls': (TRAIN_BATCH, 3, lh * lw, ns_rpn, 256, 1024),
             **multiway_cisa_cases(fh * fw, ns_rpn, r_test * bins, bins),
             'ns1': (2, 3, 1000, 1, 256, 1024),
             'ragged': (3, 2, 77, 57, 256, 1100)}
    err, sites = 0.0, {}
    for name, (g, s, nq, ns, d, c) in cases.items():
        q = torch.randn(g, nq, d, device=dev, generator=gen)
        k = torch.randn(g, s, ns, d, device=dev, generator=gen)
        v = torch.randn(g, s, ns, c, device=dev, generator=gen)
        u = torch.softmax(torch.randn(g, s, ns, device=dev, generator=gen),
                          -1)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        want = cisa_attention_shots_plain(*args)
        case_err = check_close(f'cisa_shots[{name}]',
                               cisa_attention_shots(*args), want)
        err = max(err, case_err)
        lib_err = (library(*args) - want).abs().max().item()
        if name not in ('ns1', 'ragged'):
            nbytes = 4 * (q.numel() + k.numel() + v.numel() + u.numel()
                          + g * nq * c)
            flops = 2 * g * s * nq * ns * (d + c)
            sites[name] = cisa_site(
                lambda: cisa_attention_shots(*args),
                lambda: cisa_attention_shots_plain(*args),
                lambda: library(*args), nbytes, flops)
        print(f'cisa_shots[{name}] G={g} S={s} Nq={nq} Ns={ns} D={d} C={c}:'
              f' max|kernel-plain| {case_err:.3e}, max|library-plain| '
              f'{lib_err:.3e}' + (f', {sites[name]}' if name in sites
                                  else ''), flush=True)
        del q, k, v, u, want, args
    return err, sites


def _sample_counts(rois, p):
    """Samples per bin axis that these rois need (the kernel's rule)."""
    r = rois[..., -4:] / 16.0
    ext = torch.stack([r[..., 3] - r[..., 1], r[..., 2] - r[..., 0]],
                      -1).clamp(min=1.0)
    q = torch.floor(ext / p)
    return (q + (q * p < ext).float()).clamp(1, 16)       # max_samples


def roi_taps(wy, wx, c):
    """The work of the RoIAlign kernels' shared body on these weights: one
    block per (b, r, ph) row of bins reads each kept feature row (h with
    Wy[ph, h] != 0, w with some Wx[pw, w] != 0) once.  -> (operations:
    stage 1 over the kept rows for every kept column, stage 2 over P x P
    bins; modelled bytes read through L2: kept rows x kept columns x 4 C
    summed over (b, r, ph))."""
    nh = (wy != 0).sum(-1)                                  # [B,R,P]
    nw = (wx != 0).any(-2).sum(-1)                          # [B,R]
    p = wy.shape[2]
    flops = 2 * c * (nw * (nh.sum(-1) + p * p)).sum().item()
    return flops, 4 * c * (nh * nw[..., None]).sum().item()


def roi_site(fn, plain, nbytes, flops, gather, fn_cut, library=None,
             flop_per_s=FP32_FLOP_PER_S):
    """Times of a RoIAlign kernel beside its plain version (and library
    yardstick), its bound, and its rates: GB/s of the counted bytes and of
    the modelled L2 bytes; `fn_cut`: the kernel on the same rois without
    the whole-map ones (`without_whole_map`), whose rows are the longest."""
    b_ms, b_by = bound_ms(nbytes, flops, flop_per_s)
    ms = cuda_ms(fn, 10)
    return dict(ms=ms, plain_ms=cuda_ms(plain, 3),
                library_ms=None if library is None else cuda_ms(library, 3),
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                gb_per_s=nbytes / ms / 1e6, gather_bytes=gather,
                gather_gb_per_s=gather / ms / 1e6,
                ms_without_whole_map=cuda_ms(fn_cut, 10))


def without_whole_map(rois):
    """`serving_rois` with each image's two whole-map edge rois (5 and 6)
    replaced by copies of two random ones."""
    out = rois.clone()
    out[:, 5:7] = rois[:, 8:10]
    return out


def serving_rois(b, r, gen, dev, hw=None):
    """Proposal-like rois on an image of the query bucket `hw` (default
    QUERY_HW), edge cases first."""
    h, w = hw or QUERY_HW
    edge = torch.tensor([
        [-40, -30, 60, 50], [900, 500, 1100, 700], [-300, 20, -20, 60],
        [30, 30, 30.4, 30.2], [80, 80, 60, 50], [0, 0, 3000, 2500],
        [0, 0, w - 1, h - 1], [16, 16, 16 + 21 * 16, 48]], device=dev)
    n = r - edge.shape[0]
    ctr = torch.rand(b, n, 2, device=dev, generator=gen) * torch.tensor(
        [w, h], device=dev)
    size = 2 ** (torch.rand(b, n, 2, device=dev, generator=gen) * 4 + 5)
    rand = torch.cat([ctr - size / 2, ctr + size / 2], -1)
    boxes = torch.cat([edge.expand(b, -1, -1), rand], 1)
    batch = torch.arange(b, device=dev, dtype=torch.float32)
    return torch.cat([batch[:, None, None].expand(b, r, 1), boxes],
                     -1).contiguous()


def check_roi_align(dev, gen, c=1024, hw=QUERY_HW, r=None, label=''):
    """K2 at the serving shapes: BATCH maps of the query bucket `hw` with
    `c` channels and `r` rois an image (default the test proposals)."""
    from dana_tpu_torch.ops.roi_align import (roi_align, roi_align_plain,
                                              roi_align_pw, roi_weights)
    from dana_tpu_torch.utils import config as cfg
    b, r = BATCH, r or cfg.TEST_RPN_POST_NMS_TOP_N
    p = cfg.POOLING_SIZE
    fh, fw = (s // cfg.FEAT_STRIDE for s in hw)
    feat = torch.randn(b, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(b, r, gen, dev, hw)
    want = roi_align_plain(feat, rois, p, 1 / 16.0)
    got = roi_align(feat, rois, p, 1 / 16.0)
    err = check_close(f'roi_align_fwd{label}', got, want, K2_TOL)
    weights = roi_weights(rois, fh, fw, p, 1 / 16.0)
    c3_err = check_close(f'roi_align_fwd{label} against roi_align_pw on its '
                         "rois' weights", got, roi_align_pw(feat, *weights),
                         K2_TOL)
    nbytes = 4 * (feat.numel() + rois.numel() + want.numel())
    flops, gather = roi_taps(*weights, c)
    cut = without_whole_map(rois)
    site = roi_site(lambda: roi_align(feat, rois, p, 1 / 16.0),
                    lambda: roi_align_plain(feat, rois, p, 1 / 16.0),
                    nbytes, flops, gather,
                    lambda: roi_align(feat, cut, p, 1 / 16.0))
    # K2's earlier form, a block per output bin: 4 corner rows of 4 C
    # bytes for every sample of every bin
    counts = _sample_counts(rois, p)
    site['bin_gather_bytes'] = 16 * c * p * p * (counts[..., 0]
                                                 * counts[..., 1]).sum().item()
    site['max_abs_err_vs_roi_align_pw'] = c3_err
    print(f'roi_align_fwd{label} feat={tuple(feat.shape)} '
          f'rois={tuple(rois.shape)}: max|kernel-plain| {err:.3e}, '
          f'max|K2-K3 on its weights| {c3_err:.3e}, {site}', flush=True)
    return err, site


def check_buckets(dev, gen):
    """K1 at its serving RPN site and K2 at the shapes each of the other
    query buckets gives them (BATCH images, 300 rois), against their plain
    versions, timed; -> (max errors {name: err}, {bucket: sites}).  K1's
    RoI site (Nq = 300 * 49, Ns = 49) has one shape at every bucket: phase
    3 holds it once."""
    from dana_tpu_torch.ops.cisa_attention import (
        cisa_attention_shots, cisa_attention_shots_plain)
    from dana_tpu_torch.ops.roi_align import roi_align, roi_align_plain
    from dana_tpu_torch.utils import config as cfg
    ns_rpn = (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    p = cfg.POOLING_SIZE
    errs, out = {'cisa_shots': 0.0, 'roi_align_fwd': 0.0}, {}
    for hw in OTHER_BUCKETS:
        fh, fw = (s // cfg.FEAT_STRIDE for s in hw)
        nq, ns = fh * fw, ns_rpn
        q = torch.randn(BATCH, nq, 256, device=dev, generator=gen)
        k = torch.randn(BATCH, 3, ns, 256, device=dev, generator=gen)
        v = torch.randn(BATCH, 3, ns, 1024, device=dev, generator=gen)
        u = torch.softmax(torch.randn(BATCH, 3, ns, device=dev,
                                      generator=gen), -1)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        e = check_close(f'cisa_shots[rpn {hw}]', cisa_attention_shots(*args),
                        cisa_attention_shots_plain(*args))
        errs['cisa_shots'] = max(errs['cisa_shots'], e)
        flops = 2 * BATCH * 3 * nq * ns * (256 + 1024)
        row = {'rpn': dict(
            nq=nq, max_abs_err=e,
            ms=cuda_ms(lambda: cisa_attention_shots(*args), 10),
            plain_ms=cuda_ms(lambda: cisa_attention_shots_plain(*args), 3),
            bound_ms=bound_ms(4 * (q.numel() + k.numel() + v.numel()
                                   + u.numel() + BATCH * nq * 1024),
                              flops, CISA_FLOP_PER_S)[0])}
        del q, k, v, u, args
        feat = torch.randn(BATCH, fh, fw, 1024, device=dev, generator=gen)
        rois = serving_rois(BATCH, cfg.TEST_RPN_POST_NMS_TOP_N, gen, dev, hw)
        got = roi_align(feat, rois, p, 1 / 16.0)
        e = check_close(f'roi_align_fwd[{hw}]', got,
                        roi_align_plain(feat, rois, p, 1 / 16.0), K2_TOL)
        errs['roi_align_fwd'] = max(errs['roi_align_fwd'], e)
        row['roi_align'] = dict(
            map=(fh, fw), max_abs_err=e,
            ms=cuda_ms(lambda: roi_align(feat, rois, p, 1 / 16.0), 10),
            plain_ms=cuda_ms(lambda: roi_align_plain(feat, rois, p, 1 / 16.0),
                             3),
            bound_ms=bound_ms(4 * (feat.numel() + rois.numel()
                                   + got.numel()), 0)[0])
        del feat, rois, got
        out['x'.join(map(str, hw))] = row
        print(f'bucket {hw}: {row}', flush=True)
    return errs, out


def cisa_single_library(q, k, v, u, scale, gamma):
    """K4's yardstick: SDPA plus the unary term (timed here; the port never
    calls it)."""
    import torch.nn.functional as F
    return (F.scaled_dot_product_attention(q, k, v, scale=scale)
            + gamma * (u @ v))


def check_cisa_single(dev, gen):
    """K4: single-group CISA, the cisa_shots kernel entered at S = 1."""
    from dana_tpu_torch.ops.cisa_attention import (cisa_attention,
                                                   cisa_attention_plain)
    library = cisa_single_library

    fh, fw = (s // 16 for s in QUERY_HW)
    cases = {'main': (BATCH, fh * fw, (SUPPORT_HW // 16) ** 2, 256, 1024),
             'ns1': (4, 1000, 1, 256, 1024),
             'ragged': (3, 77, 57, 256, 1100)}
    err, site = 0.0, None
    for name, (g, nq, ns, d, c) in cases.items():
        q = torch.randn(g, nq, d, device=dev, generator=gen)
        k = torch.randn(g, ns, d, device=dev, generator=gen)
        v = torch.randn(g, ns, c, device=dev, generator=gen)
        u = torch.softmax(torch.randn(g, 1, ns, device=dev, generator=gen),
                          -1)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        want = cisa_attention_plain(*args)
        case_err = check_close(f'cisa_attention[{name}]',
                               cisa_attention(*args), want)
        err = max(err, case_err)
        lib_err = (library(*args) - want).abs().max().item()
        if name == 'main':
            nbytes = 4 * (q.numel() + k.numel() + v.numel() + u.numel()
                          + g * nq * c)
            flops = 2 * g * nq * ns * (d + c)
            site = cisa_site(lambda: cisa_attention(*args),
                             lambda: cisa_attention_plain(*args),
                             lambda: library(*args), nbytes, flops)
        print(f'cisa_attention[{name}] G={g} Nq={nq} Ns={ns} D={d} C={c}: '
              f'max|kernel-plain| {case_err:.3e}, max|library-plain| '
              f'{lib_err:.3e}' + (f', {site}' if name == 'main' else ''),
              flush=True)
        del q, k, v, u, want, args
    return err, site


def check_bf16(name, got, want):
    """A bf16 kernel's output against its plain version's on the same bf16
    inputs: finite bf16, max |diff| <= BF16_ULP * max|plain|; -> (max
    |diff|, the tolerance)."""
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
        fail(f'{name}: kernel output is not finite bf16 ({got.dtype})')
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_ULP * want.float().abs().max().item()
    if not err <= tol:
        fail(f'{name}: kernel disagrees with its plain version (max |err| '
             f'{err:.3e}, tolerance {tol:.3e})')
    return err, tol


# K1-bf16 and K4-bf16 before their wgmma redesign: the simple mma.sync
# kernel's ms per call (PERF.md kernel table, the K1 @ bf16 and K4 @ bf16
# rows' times in brackets: this script's phase 3 on an NVIDIA H100 80GB
# HBM3 at 700 W)
MMA_SYNC_CISA_BF16_MS = {'rpn': 0.799, 'roi': 0.941, 'rpn_c512': 0.683,
                         'roi_c512': 0.740, 'single': 0.311}


def ptxas_report(name):
    """The register, spill and wgmma-serialisation lines nvcc's ptxas
    printed for one kernel source (build.BUILD_LOG), each named by its
    entry function."""
    from dana_tpu_torch.ops import build
    lines, entry = [], None
    for line in build.BUILD_LOG.get(name, '').splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ('spill' in line or 'ptxas info    : Used' in line
              or 'serializ' in line):
            lines.append(f'{entry}: {line.strip()}')
    return lines


def check_cisa_bf16(dev, gen):
    """K1 in bf16 at the serving path's two sites on ResNet's 1024 and
    VGG16's 512 channels, at the training step's two sites (TRAIN_BATCH
    episodes; the RoI site runs twice a step), then edge shapes, and K4 in
    bf16 (the single-group CISA, K1's bf16 kernel at S = 1) at its main
    shape: against the plain
    versions, timed beside the plain versions, SDPA in bf16 plus the unary
    term, the bound at the bf16 tensor-core rate and the mma.sync kernel's
    time, with its two phases (the probabilities into the bf16 scratch,
    then the product over the shots' keys) timed apart; -> ({'shots': K1's
    max |error|, 'single': K4's}, {site: numbers})."""
    from dana_tpu_torch.ops.cisa_attention import (
        cisa_attention, cisa_attention_plain, cisa_attention_shots,
        cisa_attention_shots_plain, cisa_probs_bf16, cisa_pv_bf16)
    from dana_tpu_torch.utils import config as cfg
    for line in ptxas_report('cisa_shots_bf16'):
        print(f'cisa_shots_bf16 ptxas: {line}', flush=True)
    bf16 = torch.bfloat16
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    ns_rpn = (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    bins = cfg.POOLING_SIZE ** 2
    r_test, r_train = cfg.TEST_RPN_POST_NMS_TOP_N, cfg.TRAIN_BATCH_SIZE
    # (G, S, Nq, Ns, D, C); S = 0 marks K4 (single group, S = 1)
    cases = {'rpn': (BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'roi': (BATCH, 3, r_test * bins, bins, 256, 1024),
             'train_rpn': (TRAIN_BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'train_roi': (TRAIN_BATCH, 3, r_train * bins, bins, 256, 1024),
             'rpn_c512': (BATCH, 3, fh * fw, ns_rpn, 256, VGG_C),
             'roi_c512': (BATCH, 3, r_test * bins, bins, 256, VGG_C),
             'single': (BATCH, 0, fh * fw, ns_rpn, 256, 1024),
             **multiway_cisa_cases(fh * fw, ns_rpn, r_test * bins, bins),
             'ns1': (2, 3, 1000, 1, 256, 1024),
             'ragged': (3, 2, 77, 57, 256, 1096)}

    errs, sites = {'shots': 0.0, 'single': 0.0}, {}
    for name, (g, s, nq, ns, d, c) in cases.items():
        single = s == 0
        lead = (g,) if single else (g, s)
        q = torch.randn(g, nq, d, device=dev, generator=gen).to(bf16)
        k = torch.randn(*lead, ns, d, device=dev, generator=gen).to(bf16)
        v = torch.randn(*lead, ns, c, device=dev, generator=gen).to(bf16)
        u = torch.softmax(torch.randn(g, max(s, 1), ns, device=dev,
                                      generator=gen), -1).to(bf16)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        fn, plain, library = (
            (cisa_attention, cisa_attention_plain, cisa_single_library)
            if single
            else (cisa_attention_shots, cisa_attention_shots_plain,
                  cisa_library))
        case_err, tol = check_bf16(f'cisa bf16[{name}]', fn(*args),
                                   plain(*args))
        family = 'single' if single else 'shots'
        errs[family] = max(errs[family], case_err)
        if name not in ('ns1', 'ragged'):
            nbytes = 2 * (q.numel() + k.numel() + v.numel() + u.numel()
                          + g * nq * c)
            flops = 2 * g * max(s, 1) * nq * ns * (d + c)
            b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
            ms = cuda_ms(lambda: fn(*args), 10)
            k4, v4 = (k[:, None], v[:, None]) if single else (k, v)
            probs = cisa_probs_bf16(q, k4, u, 1.0 / 16.0, 0.1)
            sites[name] = dict(
                ms=ms, plain_ms=cuda_ms(lambda: plain(*args), 3),
                library_ms=cuda_ms(lambda: library(*args), 5), bound_ms=b_ms,
                bound_by=b_by, bound_rate='bf16 tensor cores',
                tflop_per_s=flops / ms / 1e9, gb_per_s=nbytes / ms / 1e6,
                mma_sync_ms=MMA_SYNC_CISA_BF16_MS.get(name),
                phase_a_ms=cuda_ms(
                    lambda: cisa_probs_bf16(q, k4, u, 1.0 / 16.0, 0.1), 10),
                phase_b_ms=cuda_ms(lambda: cisa_pv_bf16(probs, v4), 10),
                flops=flops, bytes=nbytes, max_abs_err=case_err, tol=tol)
            del probs
        print(f'cisa bf16[{name}] G={g} S={s or 1} Nq={nq} Ns={ns} D={d} '
              f'C={c}: max|kernel-plain| {case_err:.3e} (tolerance '
              f'{tol:.3e})' + (f', {sites[name]}' if name in sites else ''),
              flush=True)
        if name in sites:
            t = sites[name]
            was = (f'mma.sync kernel: {t["mma_sync_ms"]} ms; '
                   if t['mma_sync_ms'] else '')
            print(f'cisa bf16[{name}]: {t["ms"]:.4f} ms ({was}phase A '
                  f'{t["phase_a_ms"]:.4f}, phase B {t["phase_b_ms"]:.4f}), '
                  f'{t["tflop_per_s"]:.1f} TFLOP/s, {t["gb_per_s"]:.1f} GB/s, '
                  f'bound {t["bound_ms"]:.4f} ms ({t["bound_by"]}), plain '
                  f'{t["plain_ms"]:.4f} ms, SDPA + unary '
                  f'{t["library_ms"]:.4f} ms', flush=True)
        del q, k, v, u, args
    return errs, sites


# K2-bf16 before its tensor-core redesign: the row-pooling body's bf16
# instance, ms per call at the first query bucket (PERF.md kernel table,
# the K2 @ bf16 row's times in brackets: this script's phase 3 on an NVIDIA
# H100 80GB HBM3 at 700 W)
ROW_POOLING_K2_BF16_MS = {'roi': 0.575, 'c512': 0.501}
TC_TAPS, TC_ROWS, TC_SLICE = 64, 64, 256    # K2-bf16's tiles (roi_align.cu)


def k2_bf16_work(rois, h, w, p, c):
    """K2-bf16's work on these rois on an h x w map of c channels: flops,
    the nonzero combined products (2 C for each (roi, bin, tap) with Wy[ph,
    h] Wx[pw, w] != 0); tap_bytes, each roi's taps (`roi_tap_extent`: the
    rows x columns of its spans) once at 2 C bytes; gather_bytes, what its
    TMA boxes read through L2 (a span's columns rounded up to 8, cut at the
    map's edge); row_gather_bytes, the row-pooling body's rule (the kept
    taps of each (roi, bin row) read apart); tc_flops, the tensor-core
    operations of the padded product (64 bin rows x the span's rows times
    its columns rounded up to 8, rounded up to 64 a roi, x C rounded up to
    256)."""
    from dana_tpu_torch.ops.roi_align import roi_tap_extent, roi_weights
    wy, wx = roi_weights(rois, h, w, p, 1 / 16.0)
    rows, cols = roi_tap_extent(rois, h, w, p, 1 / 16.0)
    ny, nx = (wy != 0).sum(-1), (wx != 0).sum(-1)           # [B,R,P]
    nh, nw = rows.sum(-1), cols.sum(-1)                      # [B,R]
    padded = (nw + 7) // 8 * 8
    read = torch.minimum(padded, w - cols.int().argmax(-1))  # inside the map
    slots = ((nh * padded + TC_TAPS - 1) // TC_TAPS).clamp(min=1)
    return dict(
        flops=2 * c * (ny.sum(-1) * nx.sum(-1)).sum().item(),
        tap_bytes=2 * c * (nh * nw).sum().item(),
        gather_bytes=2 * c * (nh * read).sum().item(),
        row_gather_bytes=2 * c * (ny * (wx != 0).any(-2).sum(-1)[..., None]
                                  ).sum().item(),
        tc_flops=2 * TC_ROWS * TC_TAPS * slots.sum().item()
        * (-(-c // TC_SLICE) * TC_SLICE))


def check_roi_align_bf16(dev, gen, card, c=1024, hw=QUERY_HW, r=None,
                         label='', row_pooling_ms=None, train=False):
    """K2 in bf16 at the serving shapes (BATCH maps of the query bucket `hw`
    with `c` channels, `r` rois an image (default the test proposals),
    rounded to bf16 as the model hands them), or with `train` at the
    training step's (TRAIN_BATCH maps, `training_rois`), against its plain
    version (the JAX package's bf16 path), timed beside it, without the
    whole-map rois and beside `row_pooling_ms`, the row-pooling kernel's
    time at the same shapes; -> (max |error|, numbers)."""
    from dana_tpu_torch.ops.roi_align import roi_align, roi_align_plain
    from dana_tpu_torch.utils import config as cfg
    p = cfg.POOLING_SIZE
    b, r = ((TRAIN_BATCH, cfg.TRAIN_BATCH_SIZE) if train
            else (BATCH, r or cfg.TEST_RPN_POST_NMS_TOP_N))
    fh, fw = (s // cfg.FEAT_STRIDE for s in hw)
    feat = torch.randn(b, fh, fw, c, device=dev, generator=gen).to(
        torch.bfloat16)
    rois = (training_rois if train else serving_rois)(b, r, gen, dev,
                                                      hw).to(torch.bfloat16)
    want = roi_align_plain(feat, rois, p, 1 / 16.0)
    err, tol = check_bf16(f'roi_align_fwd bf16{label}',
                          roi_align(feat, rois, p, 1 / 16.0), want)
    work = k2_bf16_work(rois, fh, fw, p, c)
    nbytes = 2 * feat.numel() + 4 * rois.numel() + 2 * want.numel()
    cut = without_whole_map(rois)
    site = roi_site(lambda: roi_align(feat, rois, p, 1 / 16.0),
                    lambda: roi_align_plain(feat, rois, p, 1 / 16.0),
                    nbytes, work['flops'], work['gather_bytes'],
                    lambda: roi_align(feat, cut, p, 1 / 16.0),
                    flop_per_s=BF16_FLOP_PER_S)
    site.update(tap_bytes=work['tap_bytes'],
                row_gather_bytes=work['row_gather_bytes'],
                tc_flops=work['tc_flops'],
                tc_tflop_per_s=work['tc_flops'] / site['ms'] / 1e9,
                max_abs_err=err, tol=tol, row_pooling_ms=row_pooling_ms)
    print(f'roi_align_fwd bf16{label} feat={tuple(feat.shape)} '
          f'rois={tuple(rois.shape)}: max|kernel-plain| {err:.3e} '
          f'(tolerance {tol:.3e}), {site}', flush=True)
    print(f'roi_align_fwd bf16{label} ({card}): {site["ms"]:.4f} ms '
          f'(row-pooling kernel: {site["row_pooling_ms"]} ms; without the '
          f'whole-map rois '
          f'{site["ms_without_whole_map"]:.4f}), bound '
          f'{site["bound_ms"]:.4f} ms ({site["bound_by"]}), taps '
          f'{site["tap_bytes"] / 1e9:.3f} GB (row rule '
          f'{site["row_gather_bytes"] / 1e9:.3f}), read through L2 '
          f'{site["gather_bytes"] / 1e9:.3f} GB at '
          f'{site["gather_gb_per_s"]:.1f} GB/s, tensor cores '
          f'{site["tc_tflop_per_s"]:.1f} TFLOP/s of the padded product, '
          f'plain {site["plain_ms"]:.3f} ms', flush=True)
    return err, site


def check_roi_align_bf16_all(dev, gen, card):
    """K2-bf16's ptxas report, then the kernel held and timed on ResNet's
    1024 and VGG16's 512 channels at the first query bucket, at the
    training step's shapes (TRAIN_BATCH maps, 128 sampled rois an image),
    at the other four buckets and on the --ls canvas (1000 rois an image);
    -> (max |error|, {case: numbers})."""
    for line in ptxas_report('roi_align'):
        print(f'roi_align ptxas: {line}', flush=True)
        if 'roi_align_fwd_bf16' in line and (
                'serializ' in line
                or ('spill' in line and '0 bytes spill stores, 0 bytes '
                    'spill loads' not in line)):
            fail(f'roi_align_fwd_bf16: ptxas reports {line}')
    cases = {'roi': {}, 'c512': dict(c=VGG_C, label='[c512]'),
             'train_roi': dict(train=True, label='[train]'),
             'ls': dict(hw=LS_HW, r=LS_POST_NMS, label='[ls]'),
             **{'x'.join(map(str, hw)): dict(hw=hw, label=f'[{hw}]')
                for hw in OTHER_BUCKETS}}
    err, sites = 0.0, {}
    for name, kw in cases.items():
        e, sites[name] = check_roi_align_bf16(
            dev, gen, card, row_pooling_ms=ROW_POOLING_K2_BF16_MS.get(name),
            **kw)
        err = max(err, e)
    return err, sites


def training_rois(b, r, gen, dev, hw=None):
    """Rois as the training step's sampler hands them to RoIAlign, on an
    image of the query bucket `hw` (default QUERY_HW): a quarter fg (one
    gt box of 32-432 x 32-332 px an image, its corners moved by up to a
    tenth of its size), the rest bg boxes of 32-512 px anywhere on the
    image, and at index 5 one roi over the whole map (`without_whole_map`
    replaces it)."""
    h, w = hw or QUERY_HW
    n_fg = r // 4
    span = torch.tensor([w, h], device=dev, dtype=torch.float32)
    wh = torch.rand(b, 1, 2, device=dev, generator=gen) \
        * torch.tensor([400.0, 300.0], device=dev) + 32
    xy = torch.rand(b, 1, 2, device=dev, generator=gen) * (span - wh)
    jitter = (torch.rand(b, n_fg, 4, device=dev, generator=gen) * 2 - 1) \
        * 0.1 * torch.cat([wh, wh], -1)
    fg = torch.cat([xy, xy + wh], -1) + jitter
    ctr = torch.rand(b, r - n_fg, 2, device=dev, generator=gen) * span
    size = 2 ** (torch.rand(b, r - n_fg, 2, device=dev, generator=gen) * 4
                 + 5)
    boxes = torch.cat([fg, torch.cat([ctr - size / 2, ctr + size / 2], -1)],
                      1)
    boxes[:, 5] = torch.tensor([0.0, 0.0, w - 1, h - 1], device=dev)
    batch = torch.arange(b, device=dev, dtype=torch.float32)
    return torch.cat([batch[:, None, None].expand(b, r, 1), boxes],
                     -1).contiguous()


def check_combine_backward(dev, gen, card):
    """The bf16 training RoIAlign's backward on the card
    (`roi_align_combine_backward`: the combined weights bf16(Wy * Wx)
    against the output gradient, one bf16 product over the images with
    float32 accumulation) at the training step's shapes, against the same
    formula summed in float32 and rounded once, held at one bf16 ulp of its
    scale and timed beside it and its bound (the dense product at the bf16
    tensor-core rate, or its bytes); -> numbers."""
    from dana_tpu_torch.ops.roi_align import (roi_align_combine_backward,
                                              roi_weights)
    from dana_tpu_torch.utils import config as cfg
    b, r, p, c = TRAIN_BATCH, cfg.TRAIN_BATCH_SIZE, cfg.POOLING_SIZE, 1024
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    rois = training_rois(b, r, gen, dev).to(torch.bfloat16)
    wy, wx = roi_weights(rois, fh, fw, p, 1 / 16.0)
    grad = torch.randn(b, r, p, p, c, device=dev, generator=gen).to(
        torch.bfloat16)

    def summed_in_float32():
        comb = torch.einsum('brph,brqw->brpqhw', wy, wx).to(torch.bfloat16)
        out = torch.bmm(comb.float().reshape(b, -1, fh * fw).transpose(1, 2),
                        grad.float().reshape(b, -1, c))
        return out.to(torch.bfloat16).reshape(b, fh, fw, c)
    err, tol = check_bf16('roi_align_combine_backward',
                          roi_align_combine_backward(grad, wy, wx),
                          summed_in_float32())
    flops = 2 * b * r * p * p * fh * fw * c
    nbytes = 2 * grad.numel() + 4 * (wy.numel() + wx.numel()) \
        + 2 * b * fh * fw * c
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    ms = cuda_ms(lambda: roi_align_combine_backward(grad, wy, wx), 10)
    out = dict(ms=ms, plain_ms=cuda_ms(summed_in_float32, 5), bound_ms=b_ms,
               bound_by=b_by, tflop_per_s=flops / ms / 1e9, flops=flops,
               bytes=nbytes, max_abs_err=err, tol=tol)
    print(f'roi_align_combine_backward grad={tuple(grad.shape)} map '
          f'{fh}x{fw} ({card}): max|card-float32 sums| {err:.3e} '
          f'(tolerance {tol:.3e}); {ms:.4f} ms, {out["tflop_per_s"]:.1f} '
          f'TFLOP/s, bound {b_ms:.4f} ms ({b_by}), float32 product '
          f'{out["plain_ms"]:.4f} ms', flush=True)
    return out


def pw_library(wy, feat, wx):
    """K3's yardstick: its whole function as one batched three-operand
    einsum (timed here; the port never calls it)."""
    return torch.einsum('brph,bhwc,brqw->brpqc', wy, feat, wx)


def check_roi_align_pw(dev, gen, c=1024, hw=QUERY_HW, label=''):
    """K3: RoIAlign from precomputed axis weights, at the training step's
    shapes (TRAIN_BATCH images of the canvas `hw`, 128 sampled rois, edge
    cases first) on maps of `c` channels."""
    from dana_tpu_torch.ops.roi_align import (roi_align_pw,
                                              roi_align_pw_plain,
                                              roi_weights)
    from dana_tpu_torch.utils import config as cfg
    b, r, p = TRAIN_BATCH, cfg.TRAIN_BATCH_SIZE, cfg.POOLING_SIZE
    fh, fw = (s // cfg.FEAT_STRIDE for s in hw)
    feat = torch.randn(b, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(b, r, gen, dev, hw)
    wy, wx = roi_weights(rois, fh, fw, p, 1 / cfg.FEAT_STRIDE)
    wy_cut, wx_cut = roi_weights(without_whole_map(rois), fh, fw, p,
                                 1 / cfg.FEAT_STRIDE)
    want = roi_align_pw_plain(feat, wy, wx)
    err = check_close(f'roi_align_pw{label}', roi_align_pw(feat, wy, wx),
                      want)
    lib_err = (pw_library(wy, feat, wx) - want).abs().max().item()
    nbytes = 4 * (feat.numel() + wy.numel() + wx.numel() + want.numel())
    flops, gather = roi_taps(wy, wx, c)
    site = roi_site(lambda: roi_align_pw(feat, wy, wx),
                    lambda: roi_align_pw_plain(feat, wy, wx), nbytes, flops,
                    gather, lambda: roi_align_pw(feat, wy_cut, wx_cut),
                    library=lambda: pw_library(wy, feat, wx))
    site['dense_flops'] = 2 * c * b * r * p * (fh * fw + p * fw)
    print(f'roi_align_pw{label} feat={tuple(feat.shape)} '
          f'wy={tuple(wy.shape)} wx={tuple(wx.shape)}: max|kernel-plain| '
          f'{err:.3e}, max|library-plain| {lib_err:.3e}, {site}', flush=True)
    return err, site


# the trunk's BN-act epilogues at a request's shapes (BATCH queries of
# QUERY_HW; layer4 on 300 rois a query, pooled 7x7, strided to 4x4):
# (x [N, C, H, W], residual: None, the identity or the downsample's BN)
def bn_act_sites():
    (h, w), rois = QUERY_HW, BATCH * 300
    return {'stem': ((BATCH, 64, h // 2, w // 2), None),
            'layer1': ((BATCH, 256, h // 4, w // 4), 'identity'),
            'layer3_down': ((BATCH, 1024, h // 16, w // 16), 'bn'),
            'layer4_down': ((rois, 2048, 4, 4), 'bn')}


def check_bn_act(dev, gen):
    """The trunk's BN-act epilogue (ops/bn_act.py) in float32, channels
    last, at `bn_act_sites`: the kernel's output equal to the plain
    chain's bit for bit, its time beside the plain chain's and its bound
    (x, the residual and y once each at 3.35 TB/s); and the backward at
    layer3's downsample (the incoming gradient and the saved output read,
    both gradients written)."""
    from dana_tpu_torch.ops import bn_act as ba

    def rand(*size):
        return torch.randn(size, device=dev, generator=gen)

    out = {}
    for name, (shape, residual) in bn_act_sites().items():
        c, last = shape[1], torch.channels_last
        x = rand(*shape).contiguous(memory_format=last)
        r = None if residual is None \
            else rand(*shape).contiguous(memory_format=last)
        rbn = (rand(c) + 1, rand(c)) if residual == 'bn' else (None, None)
        args = (x, rand(c) + 1, rand(c), r, *rbn)
        got, want = ba.bn_act(*args), ba.bn_act_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f'bn_act[{name}]: the kernel differs from the plain chain')
        nbytes = 4 * x.numel() * (2 if r is None else 3)
        out[name] = dict(shape=list(shape), residual=residual,
                         ms=cuda_ms(lambda: ba.bn_act(*args), 20),
                         plain_ms=cuda_ms(lambda: ba.bn_act_plain(*args), 20),
                         bound_ms=bound_ms(nbytes, 0)[0], bound_by='bytes',
                         bytes=nbytes)
        if name == 'layer3_down':
            g = rand(*shape).contiguous(memory_format=last)
            bwd = (g, got, args[1], rbn[0], True)
            grads = ba.bn_act_backward(*bwd)
            plain = ba.bn_act_backward_plain(*bwd)
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(grads, plain)):
                fail('bn_act_backward: the kernel differs from autograd\'s '
                     'ops')
            out['backward_layer3_down'] = dict(
                shape=list(shape),
                ms=cuda_ms(lambda: ba.bn_act_backward(*bwd), 20),
                plain_ms=cuda_ms(lambda: ba.bn_act_backward_plain(*bwd), 20),
                bound_ms=bound_ms(4 * g.numel() * 4, 0)[0],
                bound_by='bytes', bytes=4 * g.numel() * 4)
        print(f'bn_act[{name}]: equal to the plain chain bit for bit, '
              f'{out[name]}', flush=True)
    return out


def check_backward(dev, gen):
    """The training step's autograd Functions (K1's forward with the plain
    recompute VJP; K3's forward with the plain contraction of the saved
    weights) against autograd of the plain versions, at the training
    shapes: gradients, and forward + backward times beside a library
    yardstick and the bound of forward + backward."""
    from dana_tpu_torch.ops import cisa_attention as ca
    from dana_tpu_torch.ops import roi_align as ra
    from dana_tpu_torch.utils import config as cfg
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    g, s_, ns = TRAIN_BATCH, 3, (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    d, c, p = 256, 1024, cfg.POOLING_SIZE
    xs = [torch.randn(*shape, device=dev, generator=gen) for shape in
          ((g, fh * fw, d), (g, s_, ns, d), (g, s_, ns, c))]
    xs.append(torch.softmax(torch.randn(g, s_, ns, device=dev,
                                        generator=gen), -1))
    cot = torch.randn(g, fh * fw, c, device=dev, generator=gen)
    feat = torch.randn(g, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(g, cfg.TRAIN_BATCH_SIZE, gen, dev)
    rcot = torch.randn(g, rois.shape[1], p, p, c, device=dev, generator=gen)
    wy, wx = ra.roi_weights(rois, fh, fw, p)
    # forward + backward: CISA recomputes its forward and takes two
    # products for each of the forward's two (3x the forward's operations);
    # RoIAlign's backward runs the forward's contractions transposed
    cisa_io = sum(t.numel() for t in xs) * 2 + cot.numel() * 2
    roi_io = (feat.numel() * 2 + wy.numel() + wx.numel() + rcot.numel() * 2)
    bounds = {
        'cisa_shots': bound_ms(4 * cisa_io,
                               3 * 2 * g * s_ * fh * fw * ns * (d + c)),
        'roi_align_pw': bound_ms(4 * roi_io, 2 * roi_taps(wy, wx, c)[0])}
    cases = {
        'cisa_shots': (xs, lambda *a: ca.cisa_attention_shots(*a, 1 / 16,
                                                              0.1),
                       lambda *a: ca.cisa_attention_shots_plain(*a, 1 / 16,
                                                                0.1),
                       lambda *a: cisa_library(*a, 1 / 16, 0.1), cot),
        'roi_align_pw': ([feat], lambda f: ra.roi_align_train(f, rois, p),
                         lambda f: ra.roi_align_plain(f, rois, p),
                         lambda f: pw_library(wy, f, wx), rcot)}
    out = {}
    for name, (inputs, fn, plain, library, ct) in cases.items():
        grads, row = {}, {}
        for path, f in (('ms', fn), ('plain_ms', plain),
                        ('library_ms', library)):
            leaves = [t.detach().requires_grad_() for t in inputs]

            def backward():
                return torch.autograd.grad(f(*leaves), leaves, ct)
            grads[path] = backward()
            row[path] = cuda_ms(backward, 3)
        row['max_abs_err'] = max(
            check_close(f'{name} backward', a, b)
            for a, b in zip(grads['ms'], grads['plain_ms']))
        row['bound_ms'], row['bound_by'] = bounds[name]
        out[name] = row
    print(f'backward passes (forward + backward): {out}', flush=True)
    return out


# ------------------------------------------------------------ phase 3 (NMS)

# float32 operations of one IoU and its compare (core/boxes.py iou_matrix:
# two maxima and two minima, two subtractions and two additions for w and
# h, two clamps, the product, the union's addition and subtraction, the
# division, the compare), and of one box's area, computed once a box (two
# subtractions, two additions, the product)
NMS_IOU_OPS = 15
NMS_AREA_OPS = 5
# boxes whose IoU with a 10x10 box at the same corner is exactly float32(thr)
# ((x2 - x1, y2 - y1) of the box inside it: 5x6 = 30 and 7x10 = 70 of 100)
# and a box just past it, per threshold of the main path
NMS_EXACT = {0.3: ((4, 5), (5, 5)), 0.7: ((6, 9), (7, 9))}


@contextlib.contextmanager
def recorded_nms(record):
    """Append every NMS walk's arguments (score-sorted boxes, validity, IoU
    threshold, max_output, tile) to `record`; adds no launch."""
    from dana_tpu_torch.ops import nms
    real = nms.greedy_sorted

    def walk(sboxes, svalid, thr, m, tile):
        record.append((sboxes, svalid, thr, m, tile))
        return real(sboxes, svalid, thr, m, tile)
    nms.greedy_sorted = walk
    try:
        yield
    finally:
        nms.greedy_sorted = real


def nms_ious(pos, keep, n):
    """The IoUs the greedy walk needs on this data: every box before the
    walk stops (at max_output kept, or at the end) against every kept box
    before it.  -> (IoUs, boxes before the stop: the areas it needs)."""
    full = keep.sum(1) == keep.shape[1]
    stop = torch.where(full, pos[:, -1] + 1, n)
    idx = torch.arange(n, device=pos.device)
    # kept boxes strictly before each box i < stop
    before = torch.searchsorted(torch.where(keep, pos, n).contiguous(),
                                idx.expand(len(pos), -1).contiguous())
    return (int(torch.where(idx[None] < stop[:, None], before, 0).sum()),
            int(stop.sum()))


def nms_exact_boxes(b, n, thr, dev):
    """[b, n, 4] boxes in triples on a grid 20 px apart: a 10x10 box, one
    whose IoU with it is exactly float32(thr), one just past thr."""
    (bw, bh), (cw, ch) = NMS_EXACT[thr]
    k = torch.arange(n, device=dev)
    cell, j = k // 3, k % 3
    x = (cell % 100).float() * 20
    y = (cell // 100).float() * 20
    w = torch.stack([torch.full_like(x, 9), torch.full_like(x, bw),
                     torch.full_like(x, cw)])[j, k]
    h = torch.stack([torch.full_like(y, 9), torch.full_like(y, bh),
                     torch.full_like(y, ch)])[j, k]
    return torch.stack([x, y, x + w, y + h], -1).expand(b, n, 4).contiguous()


def nms_cases(sboxes, svalid, thr, m):
    """The adversarial cases at a site's shape [B, N] and max_output M ->
    {name: (sboxes, svalid, M)}: duplicates (every box twice in a row: IoU
    exactly 1), an IoU of exactly float32(thr), no valid box, M reached in
    the first 64 boxes (non-overlapping boxes, M 50), N cut to no multiple
    of 64."""
    b, n = svalid.shape
    dev = sboxes.device
    dup = sboxes.repeat_interleave(2, 1)[:, :n].contiguous()
    k = torch.arange(n, device=dev)
    corner = torch.stack([k % 100, k // 100], -1).float() * 20
    apart = torch.cat([corner, corner + 9], -1).expand(b, n, 4).contiguous()
    cut = n - 1 if n % 64 else n - 37
    return {'duplicates': (dup, svalid, m),
            'iou_at_thr': (nms_exact_boxes(b, n, thr, dev),
                           torch.ones_like(svalid), m),
            'no_valid': (sboxes, torch.zeros_like(svalid), m),
            'full_in_64': (apart, torch.ones_like(svalid), min(m, 50)),
            'ragged_n': (sboxes[:, :cut].contiguous(),
                         svalid[:, :cut].contiguous(), m)}


def check_nms(sites):
    """The NMS kernel against its plain version at the main path's sites
    (`sites`: {label: (sboxes, svalid, thr, M, tile)} recorded from
    phase 4's request 0 and phase 5's step 0): positions and masks equal
    on the site's own data, on every `nms_cases` case at its shape, and on
    the whole NMS (sort and walk) with every score tied; timed beside the
    plain version and the bound of the IoUs and areas the data needs.  ->
    ({label: site}, the most slots in which one comparison differed)."""
    from dana_tpu_torch.ops import nms
    out, worst = {}, 0

    def differing(got, want):
        return int(((got[0] != want[0]) | (got[1] != want[1])).sum())
    for label, (sb, sv, thr, m, tile) in sites.items():
        cases = {'site': (sb, sv, m), **nms_cases(sb, sv, thr, m)}
        for name, (b_, v_, m_) in cases.items():
            got = nms.nms_sorted(b_, v_, thr, m_, tile)
            want = nms.nms_sorted_plain(b_, v_, thr, m_, tile)
            diff = differing(got, want)
            worst = max(worst, diff)
            if diff:
                fail(f'nms[{label}, {name}]: kernel and plain version keep '
                     f'different boxes in {diff} of {got[0].numel()} slots')
        tied = torch.full(sv.shape, 0.5, device=sb.device)
        runs = []
        for route in (nms.nms_sorted, nms.nms_sorted_plain):
            saved, nms.greedy_sorted = nms.greedy_sorted, route
            try:
                runs.append(nms.nms_fixed_tiled(sb, tied, thr, m, sv, tile))
            finally:
                nms.greedy_sorted = saved
        diff = differing(*runs)
        worst = max(worst, diff)
        if diff:
            fail(f'nms[{label}, score ties]: the kernel route and the plain '
                 f'route keep different boxes in {diff} slots')
        pos, keep = nms.nms_sorted(sb, sv, thr, m, tile)
        ious, areas = nms_ious(pos, keep, sv.shape[1])
        nbytes = sb.numel() * 4 + sv.numel() + pos.numel() * 9
        b_ms, b_by = bound_ms(nbytes, ious * NMS_IOU_OPS
                              + areas * NMS_AREA_OPS)
        site = dict(
            shape=[*sv.shape, m], iou_threshold=thr,
            ms=cuda_ms(lambda: nms.nms_sorted(sb, sv, thr, m, tile), 20),
            plain_ms=cuda_ms(lambda: nms.nms_sorted_plain(sb, sv, thr, m,
                                                          tile), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, ious=ious,
            areas=areas, kept=keep.sum(1).tolist(), bytes=nbytes,
            bitmask_bytes=sv.shape[0] * sv.shape[1]
            * (-(-sv.shape[1] // 64)) * 8)
        out[label] = site
        print(f'nms[{label}] B {sv.shape[0]}, N {sv.shape[1]}, M {m}, IoU '
              f'{thr}: kernel == plain on the site and on '
              f'{list(cases)[1:]} and with '
              f'tied scores; {site["ms"]:.4f} ms (plain '
              f'{site["plain_ms"]:.4f}, bound {b_ms:.6f} by {b_by}: {ious} '
              f'IoUs), kept per image {site["kept"]}', flush=True)
    return out, worst


# ---------------------------------------------------------------- phase 4

@contextlib.contextmanager
def plain_ops():
    """Route the detector through the plain versions on the card (for the
    comparison only): the kernels' (NMS's tiled fixed point included), and
    the int8 products' exact float64 ones in place of `torch._int_mm`."""
    from dana_tpu_torch.models import dana, layers
    from dana_tpu_torch.ops import bn_act, cisa_attention, nms, roi_align
    saved = (dana.cisa_attention_shots, dana.roi_align, dana.roi_align_train,
             layers.int8_conv_acc, layers.int8_matmul, nms.greedy_sorted,
             bn_act.bn_act)
    dana.cisa_attention_shots = cisa_attention.cisa_attention_shots_plain
    dana.roi_align = roi_align.roi_align_plain
    dana.roi_align_train = roi_align.roi_align_plain
    layers.int8_conv_acc = layers.int8_conv_acc_plain
    layers.int8_matmul = layers.int8_matmul_plain
    nms.greedy_sorted = nms.nms_sorted_plain
    bn_act.bn_act = bn_act.bn_act_plain
    try:
        yield
    finally:
        (dana.cisa_attention_shots, dana.roi_align, dana.roi_align_train,
         layers.int8_conv_acc, layers.int8_matmul, nms.greedy_sorted,
         bn_act.bn_act) = saved


def match_detections(da, db, coord_atol, score_tol=1e-4):
    """Same count, same score multiset (within score_tol), equal boxes for
    every score unique within the image (equal scores may keep different
    boxes)."""
    if da.shape != db.shape:
        fail(f'detection counts differ: {da.shape} vs {db.shape}')
    if not np.allclose(np.sort(da[:, 4]), np.sort(db[:, 4]), rtol=score_tol,
                       atol=score_tol):
        fail('detection scores differ between kernel and plain paths')
    qa, qb = np.round(da[:, 4], 3), np.round(db[:, 4], 3)
    uniq, cnt = np.unique(qa, return_counts=True)
    for s in uniq[cnt == 1]:
        rb = db[qb == s]
        if len(rb) == 1 and not np.allclose(da[qa == s][:, :4], rb[:, :4],
                                            rtol=1e-4, atol=coord_atol):
            fail(f'detection boxes differ at score {s}')


@contextlib.contextmanager
def pinned_proposals(record, pinned=None):
    """Append every proposal-layer call's (inputs, outputs) to `record`;
    with `pinned`, hand the detector those proposals instead of its own."""
    from dana_tpu_torch.models import rpn
    real = rpn.proposal_layer

    def layer(probs_fg, deltas, *args, **kwargs):
        out = real(probs_fg, deltas, *args, **kwargs)
        record.append(((probs_fg, deltas), out))
        return out if pinned is None else pinned
    rpn.proposal_layer = layer
    try:
        yield
    finally:
        rpn.proposal_layer = real


def compare_paths(model, config, query, info, forward_kw, predict=None,
                  label='main path', tol=TOL):
    """One request through the kernels and through the plain versions:
    `frameworks.forward` on (query, info, **forward_kw), and `predict()`,
    the same request served (None where there is no serving path).  The
    RPN's scores and deltas, the R-CNN head's outputs and the served
    detections must agree.  The plain path is given the kernel path's
    proposals: the proposal layer ranks tens of thousands of anchors whose
    float32 scores differ in the last bits between the paths, so
    near-equal neighbours swap places and NMS then keeps a few other boxes
    (the count is printed).  `tol` bounds each output's difference and
    the detections' scores.  -> the max |diff| of each compared output."""
    from dana_tpu_torch.models import frameworks
    runs = {}
    for path in ('kernel', 'plain'):
        record = []
        pinned = runs['kernel'][0][0][1] if path == 'plain' else None
        with plain_ops() if path == 'plain' else contextlib.nullcontext(), \
                pinned_proposals(record, pinned), torch.inference_mode():
            fwd = frameworks.forward(
                model, config, torch.as_tensor(query, device=DEV),
                torch.as_tensor(info, device=DEV), **forward_kw)
            runs[path] = record, fwd, None if predict is None else predict()
    (rec_k, fk, kdets), (rec_p, fp, pdets) = runs['kernel'], runs['plain']
    (scores_k, deltas_k), (rois_k, _, mask_k) = rec_k[0]
    (scores_p, deltas_p), (rois_p, _, mask_p) = rec_p[0]
    diffs = {'rpn_scores': check_close(f'{label} rpn scores', scores_k,
                                       scores_p, tol),
             'rpn_deltas': check_close(f'{label} rpn deltas', deltas_k,
                                       deltas_p, tol)}
    diffs.update({name: check_close(f'{label} {name}', fk[name], fp[name],
                                    tol)
                  for name in ('cls_prob', 'bbox_pred')})
    moved = ((mask_k != mask_p)
             | ((rois_k - rois_p).abs() > ROI_ATOL).any(-1)).sum().item()
    print(f'{label}: kernel vs plain path on request 0: max |diff| {diffs}; '
          f'the plain path\'s own proposals differ in {moved} of '
          f'{mask_k.numel()} slots', flush=True)
    if predict is None:
        return diffs
    (dk, vk), (dp, vp) = ([x.cpu().numpy() for x in d]
                          for d in (kdets, pdets))
    for i in range(len(dk)):
        match_detections(dk[i][vk[i]], dp[i][vp[i]], coord_atol=BOX_ATOL,
                         score_tol=max(tol, 1e-4))
    print(f'{label}: detections (request 0): {vk.sum(1).tolist()} per image,'
          ' kernel path == plain path (tie-aware)', flush=True)
    return diffs


def serving_predictor(seed, model=None, s2d=False, **grid):
    """The served detector: `model`, a (config, params) pair, by default
    DAnA res50 2-way 3-shot with random weights from `seed`, on the card
    (or the `grid` Predictor keywords devices, tp, sp), the supports of
    classes 0 and 1 encoded (with `s2d` packed for the space-to-depth
    stem, data/blob.py `s2d_pack`)."""
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.utils import config as cfg
    config, params = model or cfg.get_model('res50', way=2, shot=3,
                                            seed=seed)
    rng = np.random.default_rng(seed)
    pred = Predictor(params, config, **grid)      # device='cuda'
    means = np.asarray(cfg.PIXEL_MEANS, np.float32)
    for cls in range(2):
        sup = rng.integers(0, 256, (config.n_shot, SUPPORT_HW, SUPPORT_HW,
                                    3)).astype(np.float32) - means
        pred.encode_supports(cls, blob.s2d_pack(sup) if s2d else sup)
    return pred


def serving_requests(seed, n):
    """n requests of BATCH uint8 queries -> [(query, im_info, classes)]."""
    rng = np.random.default_rng(seed + 1)
    info = np.tile(np.array([*QUERY_HW, 1.0], np.float32), (BATCH, 1))
    return [(rng.integers(0, 256, (BATCH, *QUERY_HW, 3), dtype=np.uint8),
             info, [(i + j) % 2 for j in range(BATCH)]) for i in range(n)]


def want_launches(config, n, training, int8_convs=0, batch=BATCH,
                  postprocess=True):
    """The kernel launches of n requests (or training steps) of `config`:
    K1 at the two attention sites of DAnA and cisa (three in training: the
    RoI site again for the negative supports), in the attention dtype;
    RoIAlign once in align mode, in the compute dtype (K2 serving; in
    training K3 on a float32 map, K2-bf16 on a bf16 one), the single-group
    CISA never; NMS at the proposals, and again in the detection
    postprocess of a served request (`postprocess`).  Int8 serving: `int8_convs` int8 convs a request, and with
    config.roi_align_int8 on a bf16 map the int8 RoIAlign in place of
    K2-bf16; each conv, and the RoIAlign once per image of `batch`, one
    `torch._int_mm`."""
    from dana_tpu_torch.models.dana import CACHED_SUPPORTS
    align = n if config.pooling_mode == 'align' else 0
    sites = (3 if training else 2) \
        if config.framework in CACHED_SUPPORTS else 0
    k1 = 'cisa_shots' + _suffix(config.attention_dt)
    roi = 'roi_align_fwd' + _suffix(config.compute_dtype)
    if training and config.compute_dtype == torch.float32:
        roi = 'roi_align_pw'
    if not training and config.roi_align_int8 \
            and config.compute_dtype != torch.float32:
        roi = 'roi_align_int8'
    int_mm = int8_convs * n + (align * batch if roi == 'roi_align_int8'
                               else 0)
    nms = n * (1 if training or not postprocess else 2)
    return launch_counts(**{k1: sites * n, roi: align,
                            'int8_conv': int8_convs * n, 'int_mm': int_mm,
                            'nms': nms})


def _suffix(dtype):
    """The launch counter's suffix of a kernel run in `dtype`."""
    return '_bf16' if dtype == torch.bfloat16 else ''


def serving_path(seed, model=None, label='main path', tol=TOL, n=None,
                 pred=None, keep=None, nms_record=None, requests=None):
    """n requests of `model` (serving_predictor's default: the main path;
    or of `pred`, a serving predictor built already; `requests` in place
    of `serving_requests`'), then request 0 again on the plain versions,
    held at `tol` (compare_paths); `keep` (a dict) gets request 0's
    detections under 'dets', `nms_record` (a list) request 0's NMS
    arguments (`recorded_nms`).  -> (launches, summary)."""
    from dana_tpu_torch import quant
    from dana_tpu_torch.ops import nms

    n = len(requests) if requests else (n or REQUESTS)
    pred = pred or serving_predictor(seed, model)
    requests = requests or serving_requests(seed, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    outs, req_ms = [], []
    for i, (query, info, classes) in enumerate(requests):
        t0 = time.perf_counter()
        with recorded_nms(nms_record) if i == 0 and nms_record is not None \
                else contextlib.nullcontext():
            dets, valid = pred.predict(query, info, classes)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((dets, valid))
    launches = read_launches()
    syncs = nms_syncs()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{label}: {n} requests of {list(requests[0][0].shape)} uint8, '
          f'ms per request {req_ms}, peak memory {peak:.2f} GiB, '
          f'launches {launches}, NMS host syncs {syncs}', flush=True)
    want = want_launches(pred.config, n, training=False,
                         int8_convs=quant.count_int8(pred.model))
    if launches != want:
        fail(f'{label} launches {launches}, expected {want}')
    if syncs:
        fail(f'{label}: NMS synchronised the host {syncs} times')
    if keep is not None:
        keep['dets'] = outs[0]

    for dets, valid in outs:
        if dets.shape != (BATCH, 100, 5) or valid.shape != (BATCH, 100):
            fail(f'bad output shapes {dets.shape}, {valid.shape}')
        if not torch.isfinite(dets).all():
            fail('non-finite detections')
    n_det = [int(v.sum()) for _, v in outs]

    query, info, classes = requests[0]
    diffs = compare_paths(
        pred.model, pred.config, query, info,
        dict(support_feats=pred.batch_support_feats(classes)),
        lambda: pred.predict(query, info, classes), label=label, tol=tol)
    return launches, dict(req_ms=req_ms, peak_gib=peak, nms_syncs=syncs,
                          detections=n_det, path_diffs=diffs)


# ---------------------------------------------------------------- phase 5

def training_episodes(seed, n, dev):
    """n seeded episodes: TRAIN_BATCH uint8 608x1024 queries, 1-5 class-1
    gt boxes each (MAX_GT slots, zero rows pad) and n_way * n_shot = 6
    mean-subtracted 320px supports per query, made on the card."""
    from dana_tpu_torch.utils import config as cfg
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    h, w = QUERY_HW
    b = TRAIN_BATCH
    means = torch.tensor(cfg.PIXEL_MEANS, device=dev)
    out = []
    for _ in range(n):
        wh = torch.rand(b, MAX_GT, 2, device=dev, generator=gen) \
            * torch.tensor([400.0, 300.0], device=dev) + 32
        xy = torch.rand(b, MAX_GT, 2, device=dev, generator=gen) \
            * (torch.tensor([w, h], device=dev) - wh)
        n_gt = torch.randint(1, 6, (b, 1), device=dev, generator=gen)
        filled = torch.arange(MAX_GT, device=dev)[None] < n_gt
        gt = torch.cat([xy, xy + wh - 1, torch.ones(b, MAX_GT, 1,
                                                    device=dev)], -1)
        out.append(dict(
            im_data=torch.randint(0, 256, (b, h, w, 3), device=dev,
                                  generator=gen, dtype=torch.uint8),
            im_info=torch.tensor([[h, w, 1.0]] * b, device=dev),
            gt_boxes=torch.where(filled[..., None], gt, 0.0),
            support_ims=torch.randint(
                0, 256, (b, 6, SUPPORT_HW, SUPPORT_HW, 3), device=dev,
                generator=gen).float() - means))
    return out


@contextlib.contextmanager
def recorded_step(record, pinned=None):
    """Record the training forward's draws and proposals in `record`;
    with `pinned` (a record), replay its proposals instead."""
    from dana_tpu_torch.models import rpn
    real_draws, real_layer = rpn.uniform_draws, rpn.proposal_layer

    def draws(*args, **kwargs):
        record['draws'] = real_draws(*args, **kwargs)
        return record['draws']

    def layer(*args, **kwargs):
        out = real_layer(*args, **kwargs)
        record['proposals'] = out
        return out if pinned is None else pinned['proposals']
    rpn.uniform_draws, rpn.proposal_layer = draws, layer
    try:
        yield
    finally:
        rpn.uniform_draws, rpn.proposal_layer = real_draws, real_layer


# leaves whose gradient is zero by construction (centred q and k, a
# softmax over the unary and the BA block's channel scores): they move
# only by float32 rounding
NO_GRAD = {f'{site}_{layer}_layer.bias' for site in ('rpn', 'rcnn')
           for layer in ('adapt_q', 'adapt_k', 'unary', 'channel_k')}


def head_grads(model):
    """Copies of the gradients of the trainable parameters outside the
    trunk (the attention, RPN and head layers)."""
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.requires_grad and not n.startswith('backbone.')}


def _float32(config):
    return config.compute_dtype == config.attention_dt == config.head_dt \
        == torch.float32


def compare_step(params, config, seed, batch, record, metrics, grads,
                 label):
    """The step that `record` recorded, again on the plain versions from
    the same weights, draws and proposals, against the kernel path's
    `metrics` and `grads`: in float32 the losses within LOSS_RTOL and each
    head gradient within GRAD_RTOL of its norm; in a bf16 recipe the
    losses within PATH_TOL_BF16 (absolute plus relative) and each head
    gradient within GRAD_TOL_BF16 of the norm of all of them (its reason
    beside it).  -> (loss relative diffs, worst gradient relative diff)."""
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    plain = Trainer(params, config, seed=seed)
    with plain_ops(), recorded_step({}, pinned=record):
        pm = plain.step(batch, draws=record['draws'])
    f32 = _float32(config)
    diffs = {}
    for k in (*LOSSES, 'loss'):
        a, b = metrics[k], float(pm[k])
        diffs[k] = abs(a - b) / max(abs(b), 1e-12)
        ok = (diffs[k] <= LOSS_RTOL if f32
              else abs(a - b) <= PATH_TOL_BF16 * (1 + abs(b)))
        if not ok:
            fail(f'{label} step {k}: kernel path {a}, plain path {b}')
    pg = {n: p.grad for n, p in plain.model.named_parameters()
          if n in grads and n not in NO_GRAD}
    step_norm = torch.sqrt(sum(g.norm() ** 2 for g in pg.values())).item()
    worst = worst_own = 0.0
    for n, g in pg.items():
        gap = (grads[n] - g).norm().item()
        own = gap / max(g.norm().item(), 1e-30)
        rel = own if f32 else gap / max(step_norm, 1e-30)
        worst, worst_own = max(worst, rel), max(worst_own, own)
        if not rel <= (GRAD_RTOL if f32 else GRAD_TOL_BF16):
            fail(f'{label} step gradient of {n}: |kernel - plain| is '
                 f'{rel:.3e} of its ' + ('norm' if f32 else
                                          'step\'s gradient norm'))
    scale = '' if f32 else (f' of the step\'s gradient norm ({worst_own:.3e}'
                            ' of a parameter\'s own)')
    print(f'{label} step, kernel vs plain path: loss relative diffs {diffs};'
          f' worst gradient relative diff {worst:.3e}{scale} over '
          f'{len(grads)} attention, RPN and head parameters', flush=True)
    return diffs, worst


def training_path(seed, model=None, label='main path', steps=None,
                  nms_record=None, pack=None):
    """`steps` SGD steps of the Trainer on `model`, a (config, params) pair
    (by default the main path's detector), then step 0 again on the plain
    versions; `nms_record` (a list) gets step 0's NMS arguments; `pack`
    maps each episode before its step (phase 16: the space-to-depth
    packing).  -> (launches, summary)."""
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    from dana_tpu_torch.ops import nms
    from dana_tpu_torch.utils import config as cfg

    config, params = model or cfg.get_model('res50', way=2, shot=3,
                                            seed=seed)
    steps = steps or STEPS
    trainer = Trainer(params, config, seed=seed)        # device='cuda'
    episodes = training_episodes(seed, steps, trainer.device)
    if pack is not None:
        episodes = [pack(e) for e in episodes]
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    metrics, step_ms, record = [], [], {}
    for i, batch in enumerate(episodes):
        t0 = time.perf_counter()
        with recorded_step(record) if i == 0 else contextlib.nullcontext(), \
                recorded_nms(nms_record) if i == 0 and nms_record is not None \
                else contextlib.nullcontext():
            m = trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads0 = head_grads(trainer.model)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = read_launches()
    syncs = nms_syncs()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{label} training: {steps} steps of '
          f'{list(episodes[0]["im_data"].shape)} uint8 episodes, ms per '
          f'step {step_ms}, peak memory {peak:.2f} '
          f'GiB, launches {launches}, NMS host syncs {syncs}, metrics '
          f'{metrics}', flush=True)
    want = want_launches(config, steps, training=True)
    if launches != want:
        fail(f'{label} training launches {launches}, expected {want}')
    if syncs:
        fail(f'{label}: NMS synchronised the host {syncs} times')
    for m in metrics:
        if not all(np.isfinite(m[k]) for k in (*LOSSES, 'loss')):
            fail(f'{label}: non-finite training loss: {m}')
        if m['skipped'] != 0.0 or m['fg_cnt'] <= 0:
            fail(f'{label}: a step was skipped or sampled no fg roi: {m}')
    end = trainer.model.state_dict()
    trainable = {n for n, p in trainer.model.named_parameters()
                 if p.requires_grad}
    still = {n for n in trainable if torch.equal(end[n], start[n])}
    if not still <= NO_GRAD:
        fail(f'{label}: trainable parameters did not move: '
             f'{sorted(still - NO_GRAD)}')
    moved = [n for n in start
             if n not in trainable and not torch.equal(end[n], start[n])]
    # the JAX package's trainable_mask fixes a trunk's stem and layer1
    # (cfg.FIXED_BLOCKS), which a VGG16 trunk does not have: it trains whole
    fixed = ('backbone.conv1.', *(f'backbone.layer{i}.'
                                  for i in range(1, cfg.FIXED_BLOCKS + 1)))
    want = {n for n, _ in trainer.model.named_parameters()
            if not n.startswith(fixed)}
    if moved or trainable != want:
        fail(f'{label}: frozen parameters and buffers moved ({moved}), or '
             f'the trainable set differs from trainable_mask\'s by '
             f'{sorted(trainable ^ want)}')
    del trainer, start, end
    torch.cuda.empty_cache()

    # step 0 on the plain versions: same weights, draws and proposals
    diffs, worst = compare_step(params, config, seed, episodes[0], record,
                                metrics[0], grads0, label)
    return launches, dict(step_ms=step_ms,
                          steady_step_ms=float(np.mean(step_ms[1:] or
                                                       step_ms)),
                          peak_gib=peak, metrics=metrics,
                          loss_rel_diff=diffs, grad_rel_diff=worst)


# ---------------------------------------------------------------- phase 6

def cli_path(seed, checkpath, overrides=(), label='CLI path', int8_convs=0):
    """The dataset CLI over synth_test (written beside synth_train in the
    current DANA_SYNTH_ROOT) on the card, serving the checkpoint phase 7
    wrote, with the config `overrides` (KEY VALUE ... for --set) and
    `int8_convs` int8 convs a chunk (TPU.QUANT_INT8); -> (launches,
    summary), whose 'lines' are the CLI's printed lines that name int8."""
    from dana_tpu_torch import inference
    from dana_tpu_torch.data.imdb import combined_roidb
    from dana_tpu_torch.data.synth import synth_fsod
    from dana_tpu_torch.ops import nms
    from dana_tpu_torch.utils import config as cfg
    t0 = time.perf_counter()
    synth_fsod('test', num_images=20)
    synth_fsod('train')
    synth_s = time.perf_counter() - t0
    _, roidb, _, _ = combined_roidb('synth_test', training=False,
                                    use_flipped=False)
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ['--dataset', 'synth', '--way', '2', '--shot', '3',
                '--bs', str(BATCH), '--seed', str(seed),
                '--eval_dir', out_dir, '--checkpath', checkpath]
        if overrides:
            argv += ['--set', *overrides]
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = inference.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        sys.stdout.write(out.getvalue())
        launches = read_launches()
        syncs = nms_syncs()
        with open(os.path.join(out_dir, 'detections.pkl'), 'rb') as f:
            all_boxes = pickle.load(f)
    timing = result['timing']
    chunks = timing['chunks']
    tree = cfg.default_cfg()
    cfg.cfg_from_list(tree, list(overrides))
    want = want_launches(cfg.dana_config(tree, 2, 3), chunks, training=False,
                         int8_convs=int8_convs)
    if launches != want:
        fail(f'{label} launches {launches}, expected {want} for {chunks} '
             'chunks')
    if syncs:
        fail(f'{label}: NMS synchronised the host {syncs} times')
    n_det = []
    for i, entry in enumerate(roidb):
        d = all_boxes[int(entry['gt_classes'][0])][i]
        if not (isinstance(d, np.ndarray) and d.ndim == 2
                and d.shape[1] == 5 and np.isfinite(d).all()):
            fail(f'{label}: image {i}\'s target-class cell holds {d!r}')
        n_det.append(len(d))
    stats = [float(x) for x in result['stats']]
    if len(stats) != 12 or not np.isfinite(stats).all():
        fail(f'{label}: COCOeval stats {stats}')
    summary = dict(images=timing['images'], chunks=chunks,
                   img_per_s=timing['img_per_s'], timing=timing,
                   main_s=main_s, synth_s=synth_s, nms_syncs=syncs,
                   detections=n_det, stats=stats, checkpoint=checkpath,
                   overrides=list(overrides),
                   lines=[ln for ln in out.getvalue().splitlines()
                          if 'int8' in ln])
    print(f'{label}: synth_test, {timing["images"]} images in {chunks} '
          f'chunks of {BATCH}, {timing["img_per_s"]:.2f} img/s over the set '
          f'(main {main_s:.1f} s), launches {launches}, timing {timing}, '
          f'COCOeval stats {stats} of the trained checkpoint', flush=True)
    return launches, summary


# ---------------------------------------------------------------- phase 7

TRAIN_CLI_ARGS = ['--dataset', 'synth', '--way', '2', '--shot', '3',
                  '--bs', str(TRAIN_BATCH), '--epochs', '2', '--nw', '8',
                  '--dlog', '--disp_interval', '5']


def snapshot(trainer, batch):
    """Copies of what a step starts from: parameters, momentum buffers,
    generator state, lr, and the batch."""
    opt = trainer.optimizer.state
    return dict(
        params={n: p.detach().clone()
                for n, p in trainer.model.named_parameters()},
        momentum={n: opt[p]['momentum_buffer'].clone()
                  if 'momentum_buffer' in opt.get(p, {})
                  else torch.zeros_like(p)        # no step has reached it
                  for n, p in trainer.model.named_parameters()
                  if p.requires_grad},
        generator=trainer.generator.get_state().clone(), lr=trainer.lr,
        batch={k: torch.as_tensor(v).clone() for k, v in batch.items()})


def same_snapshot(a, b):
    """-> the names of the parts that differ, bit for bit."""
    bad = [f'lr {a["lr"]} != {b["lr"]}'] if a['lr'] != b['lr'] else []
    if not torch.equal(a['generator'], b['generator']):
        bad.append('generator')
    for part in ('params', 'momentum', 'batch'):
        if a[part].keys() != b[part].keys():
            bad.append(f'{part}: other entries')
            continue
        bad += [f'{part}.{k}' for k in a[part]
                if not torch.equal(a[part][k], b[part][k])]
    return bad


@contextlib.contextmanager
def boundary_snapshots(record):
    """Record in `record['straight']` what the first step after the first
    checkpoint starts from, and in `record['resumed']` what a resumed run's
    first step starts from."""
    from dana_tpu_torch.engine.train import Trainer
    from dana_tpu_torch.utils import checkpoint as ckpt_lib
    real_step, real_save = Trainer.step, ckpt_lib.save_checkpoint
    armed = {}

    def step(self, batch, draws=None):
        key = armed.pop('key', None)
        if key is not None:
            record[key] = snapshot(self, batch)
        return real_step(self, batch, draws)

    def save(*args, **kwargs):
        if 'straight' not in record and not armed.get('resuming'):
            armed['key'] = 'straight'
        return real_save(*args, **kwargs)

    def resume():
        armed.clear()
        armed.update(key='resumed', resuming=True)

    Trainer.step, ckpt_lib.save_checkpoint = step, save
    try:
        yield resume
    finally:
        Trainer.step, ckpt_lib.save_checkpoint = real_step, real_save


def train_cli_path(seed, trainer_step_ms):
    """The training CLI on synth_train (in the current DANA_SYNTH_ROOT):
    two epochs straight, then epoch 2 again resumed from the epoch-1
    checkpoint; -> (launches, summary, the straight run's last
    checkpoint)."""
    from dana_tpu_torch import train
    from dana_tpu_torch.data.synth import synth_fsod
    t0 = time.perf_counter()
    synth_fsod('train')
    synth_s = time.perf_counter() - t0
    save_dir = os.path.join(os.path.dirname(os.environ['DANA_SYNTH_ROOT']),
                            'run')
    argv = TRAIN_CLI_ARGS + ['--seed', str(seed), '--save_dir', save_dir]
    record = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with boundary_snapshots(record) as resuming:
        t0 = time.perf_counter()
        straight = train.main(argv)
        straight_s = time.perf_counter() - t0
        first = straight['epochs'][0]
        epoch1 = train.ckpt_lib.checkpoint_path(save_dir, 1,
                                                first['steps'] - 1)
        resuming()
        t0 = time.perf_counter()
        resumed = train.main(argv + ['--r', '--checkpath', epoch1])
        resumed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    epochs = straight['epochs'] + resumed['epochs']
    steps = sum(e['steps'] for e in epochs)
    print(f'training CLI path: {[e["steps"] for e in epochs]} steps '
          f'(straight epochs 1-2, resumed epoch 2), launches {launches}, '
          f'peak memory {peak:.2f} GiB', flush=True)
    want = launch_counts(cisa_shots=3 * steps, roi_align_pw=steps,
                         nms=steps)
    if launches != want:
        fail(f'training CLI launches {launches}, expected {want} for '
             f'{steps} steps')
    if [e['epoch'] for e in epochs] != [1, 2, 2] or \
            straight['preempted'] or resumed['preempted']:
        fail(f'training CLI epochs {[e["epoch"] for e in epochs]}')
    for e in epochs:
        if e['skipped'] or not np.isfinite(e['loss_curve']).all():
            fail(f'training CLI epoch {e["epoch"]}: {e["skipped"]} skipped '
                 f'steps, losses {e["loss_curve"]}')
    if {'straight', 'resumed'} - set(record):
        fail(f'training CLI: boundary states recorded {sorted(record)}')
    bad = same_snapshot(record['straight'], record['resumed'])
    if bad:
        fail(f'the resumed state differs from the straight run\'s at the '
             f'epoch boundary: {bad[:10]} ({len(bad)} parts)')
    n_state = {k: len(record['straight'][k])
               for k in ('params', 'momentum', 'batch')}
    del record
    torch.cuda.empty_cache()
    a = np.array(straight['epochs'][1]['loss_curve'])
    b = np.array(resumed['epochs'][0]['loss_curve'])
    print(f'resumed state equals the straight run\'s at the epoch boundary '
          f'bit for bit ({n_state} tensors, generator, lr); epoch 2 losses, '
          f'straight {a.tolist()}, resumed {b.tolist()}, max |diff| '
          f'{np.abs(a - b).max():.3e} (not gated)', flush=True)
    # steady: each run's first two steps pay the first forward's set-up
    steady = [t for run in (straight, resumed)
              for t in sum((e['step_s'] for e in run['epochs']), [])[2:]]
    step_ms = float(np.median(steady) * 1e3)
    summary = dict(
        steps=[e['steps'] for e in epochs], step_ms=step_ms,
        eps_per_s=TRAIN_BATCH / step_ms * 1e3,
        trainer_step_ms=trainer_step_ms,
        epochs=[dict(epoch=e['epoch'], seconds=e['seconds'],
                     eps_per_s=e['eps_per_s'], wait_s=e['wait_s'],
                     wait_share=e['wait_s'] / e['seconds'],
                     losses=e['losses']) for e in epochs],
        peak_gib=peak, loss_curve=[e['loss_curve'] for e in epochs],
        resumed_epoch2_max_loss_diff=float(np.abs(a - b).max()),
        straight_s=straight_s, resumed_s=resumed_s, synth_s=synth_s)
    print(f'training CLI: steady step {step_ms:.2f} ms '
          f'({summary["eps_per_s"]:.2f} eps/s) against phase 5\'s '
          f'Trainer.step {trainer_step_ms:.2f} ms; per epoch '
          f'{summary["epochs"]}', flush=True)
    return launches, summary, straight['checkpoint']


# ---------------------------------------------------------------- phase 8

FRAMEWORKS = ('frcnn', 'fsod', 'meta', 'fgn', 'cisa')
FW_REQUESTS = 2               # requests a detector serves in phase 8
FW_STEPS = 2                  # training steps a detector takes in phase 8


def support_stacks(seed, n):
    """n requests' support stacks for the detectors without a support
    cache: BATCH x 3 mean-subtracted 320 px supports, host arrays."""
    from dana_tpu_torch.utils import config as cfg
    rng = np.random.default_rng(seed + 3)
    means = np.asarray(cfg.PIXEL_MEANS, np.float32)
    return [rng.integers(0, 256, (BATCH, 3, SUPPORT_HW, SUPPORT_HW, 3))
            .astype(np.float32) - means for _ in range(n)]


def framework_serving(name, config, params, seed):
    """FW_REQUESTS requests of BATCH uint8 608x1024 queries served by
    `name`: through `Predictor.predict` (cisa from its support cache, the
    siblings with each request's support stack), or for frcnn, which has
    no serving path, its eval forward; then request 0 through the plain
    versions.  -> (launches, summary)."""
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils.device import use_full_f32
    from dana_tpu_torch.utils.weights import from_jax_params
    requests = serving_requests(seed, FW_REQUESTS)
    sups = support_stacks(seed, FW_REQUESTS)
    query0, info0, classes0 = requests[0]
    if name == 'frcnn':
        use_full_f32()                  # as Predictor does on the card
        model = from_jax_params(params, config).to(DEV)
        pred = predict0 = None

        def serve(i):
            q, info, _ = requests[i]
            with torch.inference_mode():
                return frameworks.forward(model, config,
                                          torch.as_tensor(q, device=DEV),
                                          torch.as_tensor(info, device=DEV))
        forward_kw = {}
    else:
        pred = Predictor(params, config)              # device='cuda'
        model = pred.model
        if pred.caches_supports:
            for cls in range(2):
                pred.encode_supports(cls, sups[0][cls])

            def serve(i):
                return pred.predict(*requests[i])
            forward_kw = dict(support_feats=pred.batch_support_feats(
                classes0))
            predict0 = lambda: pred.predict(*requests[0])     # noqa: E731
        else:
            def serve(i):
                return pred.predict(*requests[i][:2], support_ims=sups[i])
            forward_kw = dict(support_ims=torch.as_tensor(sups[0],
                                                          device=DEV))
            predict0 = lambda: pred.predict(                   # noqa: E731
                query0, info0, support_ims=sups[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    req_ms, outs = [], []
    for i in range(FW_REQUESTS):
        t0 = time.perf_counter()
        outs.append(serve(i))
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = want_launches(config, FW_REQUESTS, training=False,
                         postprocess=name != 'frcnn')
    if launches != want:
        fail(f'{name} serving launches {launches}, expected {want}')
    for out in outs:
        if name == 'frcnn':
            shapes = (tuple(out['bbox_pred'].shape),
                      tuple(out['cls_prob'].shape))
            finite = all(torch.isfinite(out[k]).all()
                         for k in ('bbox_pred', 'cls_prob', 'rois'))
            if shapes != ((BATCH, config.test_post_nms, 8),
                          (BATCH, config.test_post_nms, 2)) or not finite:
                fail(f'frcnn eval outputs {shapes}, finite {finite}')
        else:
            dets, valid = out
            if dets.shape != (BATCH, 100, 5) or not torch.isfinite(dets).all():
                fail(f'{name} detections {tuple(dets.shape)} not finite '
                     'or of the wrong shape')
    del outs
    diffs = compare_paths(model, config, query0, info0, forward_kw, predict0,
                          label=name)
    del pred, model, forward_kw
    torch.cuda.empty_cache()
    return launches, dict(req_ms=req_ms, peak_gib=peak, path_diffs=diffs)


def all_class_gt(gt, seed):
    """The episodes' gt with two more boxes of class 2 in the last two
    slots: every class's gt, for Meta R-CNN's RPN targets."""
    gen = torch.Generator(device=gt.device).manual_seed(seed + 4)
    b = gt.shape[0]
    h, w = QUERY_HW
    wh = torch.rand(b, 2, 2, device=gt.device, generator=gen) \
        * torch.tensor([300.0, 200.0], device=gt.device) + 64
    xy = torch.rand(b, 2, 2, device=gt.device, generator=gen) \
        * (torch.tensor([w, h], device=gt.device) - wh)
    out = gt.clone()
    out[:, -2:] = torch.cat([xy, xy + wh - 1,
                             torch.full((b, 2, 1), 2.0, device=gt.device)],
                            -1)
    return out


def framework_training(name, config, params, seed, label=None):
    """FW_STEPS Trainer steps of `name` on seeded episodes (Meta R-CNN's
    with every class's gt), then step 0 again on the plain versions.
    -> (launches, summary)."""
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    label = label or name
    trainer = Trainer(params, config, seed=seed)        # device='cuda'
    episodes = training_episodes(seed, FW_STEPS, trainer.device)
    if name == 'meta':
        for ep in episodes:
            ep['all_gt_boxes'] = all_class_gt(ep['gt_boxes'], seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    metrics, step_ms, record = [], [], {}
    for i, batch in enumerate(episodes):
        t0 = time.perf_counter()
        with recorded_step(record) if i == 0 else contextlib.nullcontext():
            m = trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads0 = head_grads(trainer.model)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = want_launches(config, FW_STEPS, training=True)
    if launches != want:
        fail(f'{label} training launches {launches}, expected {want}')
    for m in metrics:
        if not all(np.isfinite(m[k]) for k in (*LOSSES, 'loss')) \
                or m['skipped'] != 0.0 or m['fg_cnt'] <= 0:
            fail(f'{label} step: non-finite, skipped or no fg roi: {m}')
    del trainer
    torch.cuda.empty_cache()
    diffs, worst = compare_step(params, config, seed, episodes[0], record,
                                metrics[0], grads0, label)
    return launches, dict(step_ms=step_ms, peak_gib=peak, metrics=metrics,
                          loss_rel_diff=diffs, grad_rel_diff=worst)


def frameworks_path(seed, card):
    """Phase 8's serving and training paths of every framework; -> ({path:
    launches}, {framework: summary})."""
    from dana_tpu_torch.utils import config as cfg
    by_path, summary = {}, {}
    for name in FRAMEWORKS:
        config, params = cfg.get_model(name, way=2, shot=3, seed=seed)
        by_path[f'{name}_serving'], serving = framework_serving(
            name, config, params, seed)
        by_path[f'{name}_training'], training = framework_training(
            name, config, params, seed)
        summary[name] = dict(serving=serving, training=training)
        print(f'{name} ({card}): serving {BATCH} x {QUERY_HW} uint8 queries, '
              f'ms per request {serving["req_ms"]}, peak memory '
              f'{serving["peak_gib"]:.2f} GiB; training {TRAIN_BATCH} '
              f'episodes, ms per step {training["step_ms"]}, peak memory '
              f'{training["peak_gib"]:.2f} GiB; launches '
              f'{by_path[f"{name}_serving"]} serving, '
              f'{by_path[f"{name}_training"]} training', flush=True)
        del params
        torch.cuda.empty_cache()
    return by_path, summary


def meta_cli_path(seed, card):
    """The two CLIs with --net meta: one epoch on synth_train, then that
    checkpoint served over synth_test (both in the current
    DANA_SYNTH_ROOT); -> ({path: launches}, summary)."""
    from dana_tpu_torch import inference, train
    from dana_tpu_torch.data.synth import synth_fsod
    synth_fsod('test', num_images=20)
    synth_fsod('train')
    save_dir = os.path.join(os.path.dirname(os.environ['DANA_SYNTH_ROOT']),
                            'run_meta')
    argv = ['--dataset', 'synth', '--net', 'meta', '--way', '2', '--shot',
            '3', '--seed', str(seed)]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    trained = train.main(argv + ['--bs', str(TRAIN_BATCH), '--epochs', '1',
                                 '--nw', '8', '--dlog', '--disp_interval',
                                 '5', '--save_dir', save_dir])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    epoch = trained['epochs'][0]
    want = launch_counts(roi_align_pw=epoch['steps'], nms=epoch['steps'])
    if train_launches != want:
        fail(f'meta training CLI launches {train_launches}, expected {want}')
    if epoch['skipped'] or not np.isfinite(epoch['loss_curve']).all():
        fail(f'meta training CLI: {epoch["skipped"]} skipped steps, losses '
             f'{epoch["loss_curve"]}')
    steady = float(np.median(epoch['step_s'][2:]) * 1e3)
    with tempfile.TemporaryDirectory() as out_dir:
        zero_launches()
        t0 = time.perf_counter()
        result = inference.main(argv + ['--bs', str(BATCH), '--eval_dir',
                                        out_dir, '--checkpath',
                                        trained['checkpoint']])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    serve_launches = read_launches()
    timing = result['timing']
    want = launch_counts(roi_align_fwd=timing['chunks'],
                         nms=2 * timing['chunks'])
    if serve_launches != want:
        fail(f'meta dataset CLI launches {serve_launches}, expected {want}')
    stats = [float(x) for x in result['stats']]
    if len(stats) != 12 or not np.isfinite(stats).all():
        fail(f'meta dataset CLI: COCOeval stats {stats}')
    summary = dict(steps=epoch['steps'], eps_per_s=epoch['eps_per_s'],
                   steady_step_ms=steady, train_s=train_s,
                   wait_s=epoch['wait_s'], losses=epoch['losses'],
                   img_per_s=timing['img_per_s'], timing=timing,
                   serve_s=serve_s, stats=stats)
    print(f'meta CLIs ({card}): training epoch 1 of synth_train, '
          f'{epoch["steps"]} steps, {epoch["eps_per_s"]:.2f} eps/s, steady '
          f'step {steady:.2f} ms, launches {train_launches}; dataset CLI '
          f'over synth_test, {timing["img_per_s"]:.2f} img/s, launches '
          f'{serve_launches}, timing {timing}, AP {stats[0]:.4f} (not '
          'judged)', flush=True)
    return {'meta_train_cli': train_launches,
            'meta_cli': serve_launches}, summary


# ---------------------------------------------------------------- phase 9

# (label, get_model's name, DanaConfig fields replaced, whether it trains)
SLICE9 = (('res101', 'res101', {}, True), ('vgg16', 'vgg16', {}, True),
          ('res152', 'res50', {'arch': 'resnet152'}, False),
          ('pool', 'res50', {'pooling_mode': 'pool'}, True),
          ('crop', 'res50', {'pooling_mode': 'crop'}, True))


def slice9_model(name, fields, seed):
    """-> (config, params): get_model's 2-way 3-shot DAnA `name` with
    `fields` replaced; a replaced trunk gets its own random weights from
    `seed`."""
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model(name, way=2, shot=3, seed=seed)
    config = dataclasses.replace(config, **fields)
    if 'arch' in fields:
        params = frameworks.init_params(config, seed=seed)
    return config, params


def slice9_path(seed, card):
    """Phase 9's serving (and training) paths of each SLICE9 case, as
    phases 4 and 5 drive the main path; -> ({path: launches}, {case:
    summary})."""
    by_path, summary = {}, {}
    for label, name, fields, trains in SLICE9:
        model = slice9_model(name, fields, seed)
        config = model[0]
        by_path[f'{label}_serving'], serving = serving_path(seed, model,
                                                            label)
        torch.cuda.empty_cache()
        summary[label] = dict(arch=config.arch,
                              pooling_mode=config.pooling_mode,
                              serving=serving)
        line = (f'{label} ({card}; {config.arch}, {config.pooling_mode}): '
                f'ms per request {serving["req_ms"]}, peak memory '
                f'{serving["peak_gib"]:.2f} GiB')
        if trains:
            by_path[f'{label}_training'], training = training_path(
                seed, model, label)
            torch.cuda.empty_cache()
            summary[label]['training'] = training
            line += (f'; ms per step {training["step_ms"]}, peak memory '
                     f'{training["peak_gib"]:.2f} GiB')
        print(line, flush=True)
        del model
    return by_path, summary


@contextlib.contextmanager
def call_count(module, name):
    """Count the calls of `module.name` in the yielded list's one entry."""
    real, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


# label -> (flags of both CLIs, the training CLI's --set, pooling mode)
SLICE9_CLI = {
    'vgg16_pool': (['--backbone', 'vgg16'], ['--set', 'POOLING_MODE', 'pool'],
                   'pool'),
    'res101_ls': (['--backbone', 'res101', '--ls'], [], 'align'),
}


def slice9_cli_path(seed, card):
    """The two CLIs on the new trunks (synth sets in the current
    DANA_SYNTH_ROOT): for each SLICE9_CLI run, one training epoch of
    synth_train, then its checkpoint served over synth_test with the same
    flags and no --set, so the pooling mode comes from the checkpoint.
    The counters are zeroed around each CLI: 3 K1 a step and 2 a chunk,
    RoIAlign once a step or chunk in align mode and never in pool mode,
    where RoIPool runs instead.  -> ({path: launches}, summary)."""
    from dana_tpu_torch import inference, train
    from dana_tpu_torch.data.synth import synth_fsod
    from dana_tpu_torch.models import dana
    synth_fsod('test', num_images=20)
    synth_fsod('train')
    base = ['--dataset', 'synth', '--way', '2', '--shot', '3', '--seed',
            str(seed)]
    by_path, summary = {}, {}
    for label, (flags, train_set, mode) in SLICE9_CLI.items():
        config = dana.DanaConfig(pooling_mode=mode)
        save_dir = os.path.join(
            os.path.dirname(os.environ['DANA_SYNTH_ROOT']), f'run_{label}')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        with call_count(dana, 'roi_pool') as pools:
            trained = train.main(base + flags + [
                '--bs', str(TRAIN_BATCH), '--epochs', '1', '--nw', '8',
                '--dlog', '--disp_interval', '5', '--save_dir', save_dir]
                + train_set)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_launches()
        epoch = trained['epochs'][0]
        want = want_launches(config, epoch['steps'], training=True)
        if launches != want or pools[0] != (epoch['steps'] * (mode == 'pool')):
            fail(f'{label} training CLI launches {launches}, RoIPool calls '
                 f'{pools[0]}, expected {want} in {mode} mode')
        if epoch['skipped'] or not np.isfinite(epoch['loss_curve']).all():
            fail(f'{label} training CLI: {epoch["skipped"]} skipped steps, '
                 f'losses {epoch["loss_curve"]}')
        by_path[f'{label}_train_cli'] = launches
        with tempfile.TemporaryDirectory() as out_dir, \
                call_count(dana, 'roi_pool') as pools:
            zero_launches()
            t0 = time.perf_counter()
            result = inference.main(base + flags + [
                '--bs', str(BATCH), '--eval_dir', out_dir, '--checkpath',
                trained['checkpoint']])
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        launches = read_launches()
        timing = result['timing']
        want = want_launches(config, timing['chunks'], training=False)
        if launches != want or \
                pools[0] != (timing['chunks'] * (mode == 'pool')):
            fail(f'{label} dataset CLI launches {launches}, RoIPool calls '
                 f'{pools[0]}, expected {want} in the checkpoint\'s {mode} '
                 'mode')
        stats = [float(x) for x in result['stats']]
        if len(stats) != 12 or not np.isfinite(stats).all():
            fail(f'{label} dataset CLI: COCOeval stats {stats}')
        by_path[f'{label}_cli'] = launches
        steady = float(np.median(epoch['step_s'][2:]) * 1e3)
        summary[label] = dict(
            steps=epoch['steps'], eps_per_s=epoch['eps_per_s'],
            steady_step_ms=steady, train_s=train_s, train_peak_gib=train_peak,
            wait_s=epoch['wait_s'], losses=epoch['losses'],
            img_per_s=timing['img_per_s'], timing=timing, serve_s=serve_s,
            stats=stats, pooling_mode=mode)
        print(f'{label} CLIs ({card}): training epoch 1 of synth_train, '
              f'{epoch["steps"]} steps, {epoch["eps_per_s"]:.2f} eps/s, '
              f'steady step {steady:.2f} ms, peak {train_peak:.2f} GiB; '
              f'dataset CLI over synth_test in the checkpoint\'s {mode} mode,'
              f' {timing["img_per_s"]:.2f} img/s, launches {launches}, AP '
              f'{stats[0]:.4f} (not judged)', flush=True)
    return by_path, summary


# --------------------------------------------------------------- phase 10

# label -> the islands of the precision recipe under TPU.COMPUTE_DTYPE
# bfloat16: the default recipe (attention follows compute, float32 head),
# pure bf16, and a float32 attention island
PRECISION = {
    'default_recipe': dict(attention_dtype=None, head_dtype=torch.float32),
    'pure_bf16': dict(attention_dtype=None, head_dtype=None),
    'attention_island': dict(attention_dtype=torch.float32,
                             head_dtype=torch.float32)}
# the dataset CLI's --set for the default recipe
RECIPE_SET = ('TPU.COMPUTE_DTYPE', 'bfloat16')
# each setting's requests after the first with the mma.sync K1-bf16, ms
# (PERF.md section 5, the serving table's rows of the three bf16 settings
# before the redesign: this script's phase 10 on an NVIDIA H100 80GB HBM3
# at 700 W)
MMA_SYNC_REQUEST_MS = {'default_recipe': (84.50, 86.81),
                       'pure_bf16': (40.02, 41.51),
                       'attention_island': (88.03, 88.55)}


def trunk_formats(config, params, query):
    """The bf16 trunk (conv1..layer3) on one request's queries in the
    channels_last memory format the port runs (the NHWC input's permuted
    view) and in contiguous NCHW; -> {format: ms}."""
    import torch.nn.functional as F
    from dana_tpu_torch.models import layers as L
    from dana_tpu_torch.models.dana import prep_query_images
    from dana_tpu_torch.utils.weights import from_jax_params
    bb = from_jax_params(params, config).backbone.to(DEV)
    x = prep_query_images(config, torch.as_tensor(query, device=DEV)) \
        .float().to(torch.bfloat16)

    def run(fmt):
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
        y = L.max_pool(F.relu(bb.bn1(bb.conv1(y))))
        return bb.layer3(bb.layer2(bb.layer1(y)))
    with torch.inference_mode():
        return {name: cuda_ms(lambda: run(fmt), 5)
                for name, fmt in (('channels_last', torch.channels_last),
                                  ('nchw', torch.contiguous_format))}


def precision_path(seed, card, f32_serving):
    """Phase 10: phase 4's detector (res50 DAnA, 2-way 3-shot, weights from
    `seed`) under each PRECISION setting serves REQUESTS requests as phase
    4 does (counters zeroed around the path: 2 K1 a request in the
    attention dtype, 1 K2 in bf16), request 0 again on the plain versions
    held at PATH_TOL_BF16; then the bf16 trunk timed in both memory
    formats.  -> ({path: launches}, summary)."""
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    f32_ms, f32_peak = f32_serving['req_ms'][1:], f32_serving['peak_gib']
    by_path, summary = {}, {}
    for label, islands in PRECISION.items():
        model = (dataclasses.replace(config, compute_dtype=torch.bfloat16,
                                     **islands), params)
        by_path[f'{label}_serving'], summary[label] = serving_path(
            seed, model, label, tol=PATH_TOL_BF16)
        torch.cuda.empty_cache()
        print(f'{label} ({card}): ms per request '
              f'{summary[label]["req_ms"]} (with the mma.sync K1-bf16: '
              f'{MMA_SYNC_REQUEST_MS[label][0]}-'
              f'{MMA_SYNC_REQUEST_MS[label][1]} after its first; float32, '
              f'phase 4: {f32_ms} after its first), peak memory '
              f'{summary[label]["peak_gib"]:.2f} GiB (float32 '
              f'{f32_peak:.2f})', flush=True)
    query = serving_requests(seed, 1)[0][0]
    summary['trunk_bf16_ms'] = trunk_formats(
        dataclasses.replace(config, compute_dtype=torch.bfloat16), params,
        query)
    print(f'bf16 trunk by memory format ({card}): '
          f'{summary["trunk_bf16_ms"]} ms a request', flush=True)
    torch.cuda.empty_cache()
    return by_path, summary


# --------------------------------------------------------------- phase 11

# phase 11's settings of the recipe in training (PRECISION's islands)
TRAIN_RECIPES = ('default_recipe', 'pure_bf16')


def _recipe(config, label):
    return dataclasses.replace(config, compute_dtype=torch.bfloat16,
                               **PRECISION[label])


def bf16_training_path(seed, card, f32_training):
    """Phase 11's Trainer paths: phase 5's detector takes STEPS steps in
    each TRAIN_RECIPES setting, each sibling and cisa FW_STEPS in the
    default recipe, and DAnA in pool and in crop mode serves one request
    and takes one step in the default recipe; counters zeroed around each
    path, step 0 (and request 0) against the plain versions at the bf16
    tolerances.  -> ({path: launches}, summary)."""
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    by_path, summary = {}, {}
    for label in TRAIN_RECIPES:
        by_path[f'{label}_training'], t = training_path(
            seed, (_recipe(config, label), params), label)
        summary[label] = t
        torch.cuda.empty_cache()
        print(f'{label} training ({card}): steady step '
              f'{t["steady_step_ms"]:.2f} ms (ms per step {t["step_ms"]}), '
              f'peak memory {t["peak_gib"]:.2f} GiB; float32 (phase 5): '
              f'{f32_training["steady_step_ms"]:.2f} ms, '
              f'{f32_training["peak_gib"]:.2f} GiB', flush=True)
    for name in FRAMEWORKS:
        fconf, fparams = cfg.get_model(name, way=2, shot=3, seed=seed)
        label = f'{name} (default recipe)'
        by_path[f'{name}_recipe_training'], t = framework_training(
            name, _recipe(fconf, 'default_recipe'), fparams, seed, label)
        summary[name] = t
        print(f'{label} training ({card}): ms per step {t["step_ms"]}, '
              f'peak memory {t["peak_gib"]:.2f} GiB', flush=True)
        del fparams
        torch.cuda.empty_cache()
    for mode in ('pool', 'crop'):
        model = (_recipe(dataclasses.replace(config, pooling_mode=mode),
                         'default_recipe'), params)
        label = f'{mode} (default recipe)'
        by_path[f'{mode}_recipe_serving'], serving = serving_path(
            seed, model, label, tol=PATH_TOL_BF16, n=1)
        by_path[f'{mode}_recipe_training'], training = training_path(
            seed, model, label, steps=1)
        summary[mode] = dict(serving=serving, training=training)
        torch.cuda.empty_cache()
        print(f'{label} ({card}): request {serving["req_ms"]} ms, step '
              f'{training["step_ms"]} ms', flush=True)
    return by_path, summary


def recipe_cli_path(seed, card, f32_cli):
    """Phase 11's CLIs (synth sets in the current DANA_SYNTH_ROOT): the
    training CLI trains one epoch of synth_train in the default recipe
    (RECIPE_SET; counters zeroed around it: 3 bf16 K1 and 1 bf16 K2 a step,
    nothing else), then the dataset CLI serves that checkpoint over
    synth_test in the default recipe and in pure bf16, each AP printed
    beside phase 6's float32 AP (not judged).  -> ({path: launches},
    summary)."""
    from dana_tpu_torch import train
    from dana_tpu_torch.data.synth import synth_fsod
    from dana_tpu_torch.utils import config as cfg
    synth_fsod('train')
    save_dir = os.path.join(os.path.dirname(os.environ['DANA_SYNTH_ROOT']),
                            'run_recipe')
    argv = ['--dataset', 'synth', '--way', '2', '--shot', '3', '--bs',
            str(TRAIN_BATCH), '--epochs', '1', '--nw', '8', '--dlog',
            '--disp_interval', '5', '--seed', str(seed), '--save_dir',
            save_dir, '--set', *RECIPE_SET]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    trained = train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    epoch = trained['epochs'][0]
    tree = cfg.default_cfg()
    cfg.cfg_from_list(tree, list(RECIPE_SET))
    want = want_launches(cfg.dana_config(tree, 2, 3), epoch['steps'],
                         training=True)
    if launches != want:
        fail(f'recipe training CLI launches {launches}, expected {want}')
    if epoch['skipped'] or not np.isfinite(epoch['loss_curve']).all():
        fail(f'recipe training CLI: {epoch["skipped"]} skipped steps, '
             f'losses {epoch["loss_curve"]}')
    steady = float(np.median(epoch['step_s'][2:]) * 1e3)
    by_path = {'recipe_train_cli': launches}
    summary = dict(steps=epoch['steps'], eps_per_s=epoch['eps_per_s'],
                   steady_step_ms=steady, train_s=train_s, peak_gib=peak,
                   wait_s=epoch['wait_s'], losses=epoch['losses'])
    print(f'recipe training CLI ({card}): epoch 1 of synth_train, '
          f'{epoch["steps"]} steps, {epoch["eps_per_s"]:.2f} eps/s, steady '
          f'step {steady:.2f} ms, peak {peak:.2f} GiB, launches {launches}',
          flush=True)
    for label, overrides in (
            ('default_recipe', RECIPE_SET),
            ('pure_bf16', RECIPE_SET + ('TPU.HEAD_DTYPE', 'bfloat16'))):
        by_path[f'recipe_trained_{label}_cli'], served = cli_path(
            seed, trained['checkpoint'], overrides,
            label=f'dataset CLI ({label}) on the recipe-trained checkpoint')
        summary[label] = served
        print(f'the recipe-trained checkpoint served in the {label} '
              f'({card}): AP {served["stats"][0]:.4f}, '
              f'{served["img_per_s"]:.2f} img/s; phase 6 (float32 training '
              f'and serving): AP {f32_cli["stats"][0]:.4f} (AP not judged)',
              flush=True)
    return by_path, summary


# --------------------------------------------------------------- phase 12

MULTIWAY_WAY = 5            # BASELINE config #4: 5-way, MULTIWAY_SHOTS shots
# TRAIN_CLI_ARGS without --dataset: the training CLI's default, pascal_voc
VOC_TRAIN_ARGS = ['--way', '2', '--shot', '3', '--bs', str(TRAIN_BATCH),
                  '--epochs', '1', '--nw', '8', '--dlog', '--disp_interval',
                  '5']


def multiway_path(seed, card, checkpath):
    """Phase 12 (a): `multiway_eval` serves phase 7's checkpoint over
    synth_test at MULTIWAY_WAY ways and each MULTIWAY_SHOTS shot count
    (counters zeroed around each run: 2 K1 and 1 K2 an image, its ways one
    request); then request 0 of each shot count at full serving size (one
    608x1024 query as the request's MULTIWAY_WAY rows, 6000 / 300
    proposals, ResNet-50 with weights from `seed`) in float32 and in the
    default recipe, kernel path against plain path as phases 4 and 10 hold
    theirs.  -> ({path: launches}, summary)."""
    from dana_tpu_torch import multiway_eval
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.utils import config as cfg
    by_path, summary = {}, {}
    for shot in MULTIWAY_SHOTS:
        label = f'{MULTIWAY_WAY}-way {shot}-shot'
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        result = multiway_eval.main([checkpath, str(MULTIWAY_WAY), str(shot)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = read_launches()
        images = result['timing']['images']
        want = launch_counts(cisa_shots=2 * images, roi_align_fwd=images,
                             nms=2 * images)
        if launches != want:
            fail(f'{label} evaluation launches {launches}, expected {want}')
        stats = [float(x) for x in result['stats']]
        if len(stats) != 12 or not np.isfinite(stats).all():
            fail(f'{label} evaluation: COCOeval stats {stats}')
        by_path[f'multiway_s{shot}'] = launches
        summary[label] = dict(
            images=images, img_per_s=result['timing']['img_per_s'],
            main_s=main_s, stats=stats,
            launches_per_image={k: v / images for k, v in launches.items()
                                if v})
        print(f'{label} evaluation of phase 7\'s checkpoint over synth_test '
              f'({card}): {images} images, '
              f'{result["timing"]["img_per_s"]:.2f} img/s (main '
              f'{main_s:.1f} s), AP {stats[0]:.4f}, AP50 {stats[1]:.4f} (not '
              f'judged), launches per image '
              f'{summary[label]["launches_per_image"]}', flush=True)
    query = serving_requests(seed, 1)[0][0][:1]
    info = np.array([[*QUERY_HW, 1.0]] * MULTIWAY_WAY, np.float32)
    rng = np.random.default_rng(seed + 3)
    means = np.asarray(cfg.PIXEL_MEANS, np.float32)
    for shot in MULTIWAY_SHOTS:
        config, params = cfg.get_model('res50', way=MULTIWAY_WAY, shot=shot,
                                       seed=seed)
        sups = rng.integers(0, 256, (MULTIWAY_WAY, shot, SUPPORT_HW,
                                     SUPPORT_HW, 3)).astype(np.float32) - means
        for recipe, tol in (('float32', TOL),
                            ('default_recipe', PATH_TOL_BF16)):
            conf = config if recipe == 'float32' else _recipe(config, recipe)
            label = f'{MULTIWAY_WAY}-way {shot}-shot request ({recipe})'
            pred = Predictor(params, conf)               # device='cuda'
            ways = list(range(MULTIWAY_WAY))
            for cls in ways:
                pred.encode_supports(cls, sups[cls])
            queries = np.repeat(query, MULTIWAY_WAY, 0)
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            dets, valid = pred.predict(queries, info, ways)
            torch.cuda.synchronize()
            req_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            want = want_launches(conf, 1, training=False)
            if launches != want:
                fail(f'{label} launches {launches}, expected {want}')
            if dets.shape != (MULTIWAY_WAY, 100, 5) \
                    or not torch.isfinite(dets).all():
                fail(f'{label}: detections {tuple(dets.shape)} not finite '
                     'or of the wrong shape')
            diffs = compare_paths(
                pred.model, conf, queries, info,
                dict(support_feats=pred.batch_support_feats(ways)),
                lambda: pred.predict(queries, info, ways), label=label,
                tol=tol)
            by_path[f'multiway_request_s{shot}_{recipe}'] = launches
            summary[label] = dict(req_ms=req_ms, path_diffs=diffs)
            print(f'{label} ({card}): {req_ms:.2f} ms (the first request of '
                  f'its predictor), launches {launches}', flush=True)
            del pred
            torch.cuda.empty_cache()
    return by_path, summary


def write_voc(data_dir, year='2007'):
    """A VOC<year> devkit under data_dir holding the synth scenes of the
    current DANA_SYNTH_ROOT: synth_train as trainval, synth_test as test;
    each scene's PPM bytes as JPEGImages/<index>.jpg (cv2 and the port's
    reader pick the decoder by signature), its boxes 1-based in
    Annotations/<index>.xml, synth class k as VOC_CLASSES[k]; -> the
    (trainval, test) image counts."""
    from dana_tpu_torch.data.pascal_voc import VOC_CLASSES
    from dana_tpu_torch.data.synth import synth_fsod
    voc = os.path.join(data_dir, f'VOCdevkit{year}', f'VOC{year}')
    for sub in ('Annotations', 'JPEGImages', os.path.join('ImageSets',
                                                          'Main')):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    counts = []
    for split, ds in (('trainval', synth_fsod('train')),
                      ('test', synth_fsod('test', num_images=20))):
        names = []
        for i, entry in enumerate(ds.roidb):
            name = f'{split}_{i:06d}'
            names.append(name)
            with open(ds.image_path_at(i), 'rb') as src, \
                    open(os.path.join(voc, 'JPEGImages', name + '.jpg'),
                         'wb') as dst:
                dst.write(src.read())
            objs = ''.join(
                f'<object><name>{VOC_CLASSES[int(c)]}</name>'
                '<difficult>0</difficult><bndbox>'
                + ''.join(f'<{k}>{int(v) + 1}</{k}>' for k, v in
                          zip(('xmin', 'ymin', 'xmax', 'ymax'), box))
                + '</bndbox></object>'
                for box, c in zip(entry['boxes'], entry['gt_classes']))
            with open(os.path.join(voc, 'Annotations', name + '.xml'),
                      'w') as f:
                f.write(f'<annotation><size><width>{entry["width"]}</width>'
                        f'<height>{entry["height"]}</height><depth>3</depth>'
                        f'</size>{objs}</annotation>')
        with open(os.path.join(voc, 'ImageSets', 'Main', split + '.txt'),
                  'w') as f:
            f.write(''.join(n + '\n' for n in names))
        counts.append(len(names))
    return counts


def voc_cli_path(seed, card):
    """Phase 12 (b): the training CLI with its default --dataset
    (pascal_voc: voc_2007_trainval) trains one epoch on write_voc's devkit
    under a temporary DATA_DIR, then the dataset CLI serves that checkpoint
    over voc_2007_test (counters zeroed around each: 3 K1 and 1 K3 a step,
    2 K1 and 1 K2 a chunk); the VOC mean AP is printed, not judged.  ->
    ({path: launches}, summary)."""
    from dana_tpu_torch import inference, train
    data_dir = os.path.join(os.path.dirname(os.environ['DANA_SYNTH_ROOT']),
                            'voc_data')
    n_trainval, n_test = write_voc(data_dir)
    argv = VOC_TRAIN_ARGS + ['--seed', str(seed), '--save_dir',
                             os.path.join(data_dir, 'run'),
                             '--set', 'DATA_DIR', data_dir]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    trained = train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    epoch = trained['epochs'][0]
    want = launch_counts(cisa_shots=3 * epoch['steps'],
                         roi_align_pw=epoch['steps'], nms=epoch['steps'])
    if train_launches != want:
        fail(f'VOC training CLI launches {train_launches}, expected {want}')
    if epoch['skipped'] or not np.isfinite(epoch['loss_curve']).all():
        fail(f'VOC training CLI: {epoch["skipped"]} skipped steps, losses '
             f'{epoch["loss_curve"]}')
    print(f'training CLI, default --dataset pascal_voc ({card}): '
          f'{n_trainval} trainval images, {epoch["steps"]} steps, '
          f'{epoch["eps_per_s"]:.2f} eps/s, {train_s:.1f} s, launches '
          f'{train_launches}', flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        zero_launches()
        t0 = time.perf_counter()
        result = inference.main(
            ['--dataset', 'pascal_voc', '--way', '2', '--shot', '3', '--bs',
             str(BATCH), '--seed', str(seed), '--eval_dir', out_dir,
             '--checkpath', trained['checkpoint'], '--set', 'DATA_DIR',
             data_dir])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_launches = read_launches()
    chunks = result['timing']['chunks']
    want = launch_counts(cisa_shots=2 * chunks, roi_align_fwd=chunks,
                         nms=2 * chunks)
    if eval_launches != want:
        fail(f'VOC dataset CLI launches {eval_launches}, expected {want}')
    aps = list(result['ap'].values())
    if len(aps) != 20 or not np.isfinite(aps + [result['map']]).all():
        fail(f'VOC dataset CLI: per-class AP {result["ap"]}')
    print(f'dataset CLI on voc_2007_test ({card}): {n_test} images in '
          f'{chunks} chunks, {result["timing"]["img_per_s"]:.2f} img/s, VOC '
          f'mean AP {result["map"]:.4f} over 20 classes (not judged), '
          f'launches {eval_launches}', flush=True)
    return ({'voc_train_cli': train_launches, 'voc_cli': eval_launches},
            dict(train_steps=epoch['steps'], train_eps_per_s=epoch['eps_per_s'],
                 train_s=train_s, eval_s=eval_s, chunks=chunks,
                 img_per_s=result['timing']['img_per_s'],
                 mean_ap=result['map'], ap=result['ap']))


def product_path(seed, card):
    """Phase 12 (c): DAnA with attention_type 'product' (weights from
    `seed` at its widths, the RPN conv and the R-CNN transform scaled by
    PRODUCT_SCALE: the reason beside it) serves two requests as phase 4
    does and takes one step as phase 5 does, each against the plain path
    at their tolerances.  ->
    ({path: launches}, summary)."""
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils import config as cfg
    config, _ = cfg.get_model('res50', way=2, shot=3, seed=seed)
    config = dataclasses.replace(config, attention_type='product')
    params = frameworks.init_params(config, seed=seed)
    for layer in (params['RCNN_rpn']['RPN_Conv'],
                  params['rcnn_transform_layer']):
        layer['weight'] = layer['weight'] * np.float32(PRODUCT_SCALE)
    model = (config, params)
    serving_launches, serving = serving_path(seed, model, 'product', n=2)
    torch.cuda.empty_cache()
    # one step: at lr 1e-3 the random-init product detector's first update
    # grows its loss a thousandfold (3.5 -> 2742 in a CPU rehearsal at 256 x
    # 320), which says nothing of the kernels
    training_launches, training = training_path(seed, model, 'product',
                                                steps=1)
    torch.cuda.empty_cache()
    print(f'product attention ({card}): ms per request {serving["req_ms"]}, '
          f'ms per step {training["step_ms"]}', flush=True)
    return ({'product_serving': serving_launches,
             'product_training': training_launches},
            dict(serving=serving, training=training))


def remat_path(seed, card):
    """Phase 12 (d): phase 5's first step with TPU.REMAT_BACKBONE False and
    True, from the same weights, episode, draws and proposals: equal losses
    and every trainable gradient within REMAT_TOL of the step's gradient
    norm (the backward recomputes the same trunk forward); both peak
    memories printed.  -> ({path: launches}, summary)."""
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    from dana_tpu_torch.utils import config as cfg
    c = cfg.default_cfg()
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    batch = training_episodes(seed, 1, DEV)[0]
    runs, by_path, record = {}, {}, {}
    for remat in (False, True):
        cfg.cfg_from_list(c, ['TPU.REMAT_BACKBONE', str(remat)])
        conf = dataclasses.replace(
            config, remat_backbone=cfg.dana_config(c, 2, 3).remat_backbone)
        trainer = Trainer(params, conf, seed=seed)        # device='cuda'
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        with recorded_step(record if not remat else {},
                           pinned=record if remat else None):
            metrics = trainer.step(batch, draws=record.get('draws'))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        by_path[f'remat_{remat}'] = read_launches()
        if by_path[f'remat_{remat}'] != want_launches(conf, 1, True):
            fail(f'remat {remat} step launches {by_path[f"remat_{remat}"]}')
        runs[remat] = dict(
            metrics={k: float(metrics[k]) for k in (*LOSSES, 'loss')},
            grads={n: p.grad.clone() for n, p in
                   trainer.model.named_parameters() if p.requires_grad},
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            step_ms=step_ms)
        del trainer
        torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    if plain['metrics'] != remat['metrics']:
        fail(f'remat step losses {remat["metrics"]} differ from '
             f'{plain["metrics"]}')
    norm = torch.sqrt(sum(g.norm() ** 2 for g in plain['grads'].values()))
    gap = max((remat['grads'][n] - g).norm().item()
              for n, g in plain['grads'].items()) / norm.item()
    same = sum(torch.equal(remat['grads'][n], g)
               for n, g in plain['grads'].items())
    if not gap <= REMAT_TOL:
        fail(f'remat step gradients differ by {gap:.3e} of the step\'s '
             'gradient norm')
    print(f'remat_backbone ({card}): losses equal, worst gradient gap '
          f'{gap:.3e} of the step\'s gradient norm ({same} of '
          f'{len(plain["grads"])} gradients bit for bit); peak memory '
          f'{plain["peak_gib"]:.2f} GiB without, {remat["peak_gib"]:.2f} GiB '
          f'with ({1 - remat["peak_gib"] / plain["peak_gib"]:.3f} less); '
          f'step {plain["step_ms"]:.2f} / {remat["step_ms"]:.2f} ms (the '
          'first step of each trainer)', flush=True)
    return by_path, dict(
        grad_gap=gap, grads_bit_equal=same, n_grads=len(plain['grads']),
        peak_gib=plain['peak_gib'], remat_peak_gib=remat['peak_gib'],
        step_ms=plain['step_ms'], remat_step_ms=remat['step_ms'])


# --------------------------------------------------------------- phase 13

# the data-parallel step (phase 13 (b)): the parameters after one step,
# two ranks against one process, as a share of that step's whole update
# (lr times the gradient with its weight decay): the ranks' gradient mean
# sums in another order, and cuDNN's backward is not deterministic on the
# card (float32: GRAD_RTOL; the recipe: GRAD_TOL_BF16)
CHILD_TIMEOUT_S = 420


def grid_devices(n=2):
    """n devices for a serving grid: the first n cards, or cuda:0 named n
    times when there are fewer (the sharding code runs all the same)."""
    if torch.cuda.device_count() >= n:
        return [torch.device('cuda', i) for i in range(n)]
    return [DEV] * n


def parallel_modes():
    """Phase 13 (a)'s grids: --mGPUs semantics (every card, data rows),
    tp=2 and sp=2 -> {mode: Predictor keywords}."""
    count = torch.cuda.device_count()
    return {'mGPUs': dict(devices=grid_devices(max(2, count))),
            'tp2': dict(devices=grid_devices(2), tp=2),
            'sp2': dict(devices=grid_devices(2), sp=2)}


@contextlib.contextmanager
def row_pinned(record, pinned):
    """`pinned_proposals` for a grid Predictor: its proposal layer runs
    once per data row, and each call is handed its rows of the unsharded
    request's proposals (their batch column made the row's own).  An int8
    model's rows call it from threads of their own: a call takes the rows
    of its thread's ScaleGroup index, and `record` gets the calls in row
    order when the block ends."""
    from dana_tpu_torch.models import layers as L
    from dana_tpu_torch.models import rpn
    real = rpn.proposal_layer
    rois, scores, mask = pinned
    start, calls, lock = [0], {}, threading.Lock()

    def layer(probs_fg, deltas, *args, **kwargs):
        out = real(probs_fg, deltas, *args, **kwargs)
        b, row = probs_fg.shape[0], L.scale_group_row()
        with lock:
            s = start[0] if row is None else row * b
            start[0] += b
            calls[s] = ((probs_fg, deltas), out)
        dev = probs_fg.device
        r = rois[s:s + b].to(dev).clone()
        r[..., 0] -= s
        return r, scores[s:s + b].to(dev), mask[s:s + b].to(dev)
    rpn.proposal_layer = layer
    try:
        yield
    finally:
        rpn.proposal_layer = real
        record.extend(calls[s] for s in sorted(calls))


def compare_grid(pred, base, query, info, classes, label):
    """Request 0 on a grid Predictor against the unsharded `base`, both on
    the unsharded request's proposals: RPN scores and deltas, cls_prob and
    bbox_pred at TOL, the detections tie-aware at BOX_ATOL (phase 4's
    tolerances).  -> the max |diff| of each."""
    rec0 = []
    with pinned_proposals(rec0):
        want = base.forward(query, info, classes)
    (s0, d0), pinned = rec0[0]
    with pinned_proposals([], pinned):
        wd, wv = base.predict(query, info, classes)
    rec = []
    with row_pinned(rec, pinned):
        got = pred.forward(query, info, classes)
    with row_pinned([], pinned):
        gd, gv = pred.predict(query, info, classes)
    cat = [torch.cat([r[0][i].to(DEV) for r in rec]) for i in (0, 1)]
    diffs = {'rpn_scores': check_close(f'{label} rpn scores', cat[0], s0),
             'rpn_deltas': check_close(f'{label} rpn deltas', cat[1], d0)}
    diffs.update({k: check_close(f'{label} {k}', got[k], want[k])
                  for k in ('cls_prob', 'bbox_pred')})
    (gd, gv), (wd, wv) = ([x.cpu().numpy() for x in d]
                          for d in ((gd, gv), (wd, wv)))
    for i in range(len(gd)):
        match_detections(gd[i][gv[i]], wd[i][wv[i]], coord_atol=BOX_ATOL)
    return diffs


# the counter table's op of each kernel counted by device
BY_DEVICE_OPS = {'cisa_shots': 'cisa_shots', 'roi_align_fwd': 'roi_align',
                 'roi_align_pw': 'roi_align_pw', 'nms': 'nms',
                 'int_mm': 'int8_matmul'}


def _by_device():
    """This process's launches of K1, K2, K3, NMS and the int8 products
    (`torch._int_mm`) since `zero_launches`, by device and dtype: {name:
    {'<device>/<dtype>': n}} (the table's `<op>.<dtype>@<device>`)."""
    out = {name: {} for name in BY_DEVICE_OPS}
    for key, n in _since_zero().items():
        if '@' not in key or not n:
            continue
        kind, dev = key.split('@', 1)
        op, dtype = kind.rsplit('.', 1)
        for name, o in BY_DEVICE_OPS.items():
            if o == op:
                out[name][f'{dev}/{dtype}'] = n
    return out


def grid_serving_path(seed, card):
    """Phase 13 (a): phase 4's detector and requests on each grid of
    `parallel_modes`, REQUESTS requests timed beside the unsharded
    predictor's in this call, launches counted by device, request 0
    against the unsharded request.  -> ({path: launches}, summary)."""
    base = serving_predictor(seed)
    requests = serving_requests(seed, REQUESTS)
    by_path, summary = {}, {}
    base_ms = []
    for query, info, classes in requests:
        t0 = time.perf_counter()
        base.predict(query, info, classes)
        torch.cuda.synchronize()
        base_ms.append((time.perf_counter() - t0) * 1e3)
    summary['unsharded_req_ms'] = base_ms
    for mode, kw in parallel_modes().items():
        pred = serving_predictor(seed, **kw)
        devs = sorted({str(d) for d in kw['devices']})
        torch.cuda.synchronize()
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        zero_launches()
        req_ms = []
        for query, info, classes in requests:
            t0 = time.perf_counter()
            dets, valid = pred.predict(query, info, classes)
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
            if dets.shape != (BATCH, 100, 5) or not torch.isfinite(
                    dets).all():
                fail(f'{mode}: bad detections {tuple(dets.shape)}')
        launches, by_dev = read_launches(), _by_device()
        peak = {d: torch.cuda.max_memory_allocated(d) / 2 ** 30
                for d in devs}
        rows = len(pred.rows)
        want = launch_counts(cisa_shots=2 * rows * REQUESTS,
                             roi_align_fwd=rows * REQUESTS,
                             nms=2 * rows * REQUESTS)
        if launches != want:
            fail(f'{mode} launches {launches}, expected {want}')
        leads = [str(r.lead) for r in pred.rows]
        want_dev = {d: leads.count(d) * REQUESTS for d in set(leads)}
        for name, per in (('cisa_shots', 2), ('roi_align_fwd', 1),
                          ('nms', 2)):
            got = {k.split('/')[0]: v for k, v in by_dev[name].items()}
            if got != {d: per * n for d, n in want_dev.items()}:
                fail(f'{mode} {name} launches by device {got}, expected '
                     f'{per} a request on each data row\'s first device '
                     f'{want_dev}')
        diffs = compare_grid(pred, base, *requests[0], label=mode)
        by_path[f'{mode}_serving'] = launches
        summary[mode] = dict(grid=repr(pred.grid), devices=[
            str(d) for d in kw['devices']], req_ms=req_ms, peak_gib=peak,
            by_device=by_dev, path_diffs=diffs)
        print(f'{mode} ({card}, {torch.cuda.device_count()} device(s) '
              f'seen): {pred.grid} over {[str(d) for d in kw["devices"]]}, '
              f'ms per request {req_ms} (unsharded in this call: '
              f'{base_ms}), peak memory {peak} GiB, launches by device '
              f'{by_dev}; request 0 against the unsharded one: max |diff| '
              f'{diffs}, detections equal (tie-aware)', flush=True)
        del pred
        torch.cuda.empty_cache()
    return by_path, summary


def run_children(cmds, tmp, tag, env=None):
    """Start every command (output to a file, not a pipe: a rank blocked
    on a full pipe would strand its peer in a collective), wait for all,
    kill all at CHILD_TIMEOUT_S; fail unless each exits 0.  -> their
    outputs."""
    procs = []
    for i, cmd in enumerate(cmds):
        log = open(os.path.join(tmp, f'{tag}{i}.log'), 'w+')
        procs.append((subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, **(env or {})),
            cwd=os.path.dirname(os.path.abspath(__file__))), log))
    outs, deadline = [], time.time() + CHILD_TIMEOUT_S
    try:
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            outs.append(log.read())
            log.close()
    for (p, _), out in zip(procs, outs):
        if p.returncode != 0:
            fail(f'a {tag} process exited {p.returncode}:\n{out[-4000:]}')
    return outs


def dp_step_path(seed, card, tmp):
    """Phase 13 (b): phase 5's detector and first batch of 4 episodes as
    one data-parallel step of 2 ranks (tools/torch_dist_step.py: nccl on
    two cards, gloo when they share one), started with a cold kernel
    build directory, in float32 and in the default recipe, each against
    the one-process step from the same weights and generator seed; then 3
    timed steps each way.  -> ({path: launches}, summary)."""
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    batch = {k: v.cpu().numpy()
             for k, v in training_episodes(seed, 1, DEV)[0].items()}
    runs = [dict(label='float32', config=config, trainer=dict(seed=seed)),
            dict(label='default_recipe',
                 config=_recipe(config, 'default_recipe'),
                 trainer=dict(seed=seed))]
    inputs = os.path.join(tmp, 'dp_inputs.pkl')
    with open(inputs, 'wb') as f:
        pickle.dump(dict(params=params, batch=batch, runs=runs,
                         lr=cfg.TRAIN_LEARNING_RATE), f)
    build_dir = os.path.join(tmp, 'cold_build')
    t0 = time.perf_counter()
    harness = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'tools', 'torch_dist_step.py')
    run_children([[sys.executable, harness, '--inputs', inputs, '--out',
                   os.path.join(tmp, f'dp_rank{r}.pkl'), '--rank', str(r),
                   '--world', '2', '--init', f'file://{tmp}/dp_rdzv',
                   '--time_steps', '3'] for r in (0, 1)], tmp, 'dp_rank',
                 env={'DANA_BUILD_DIR': build_dir})
    ranks_s = time.perf_counter() - t0
    built = sorted(os.listdir(build_dir))
    ranks = []
    for r in (0, 1):
        with open(os.path.join(tmp, f'dp_rank{r}.pkl'), 'rb') as f:
            ranks.append(pickle.load(f))
    by_path, summary = {}, dict(ranks_s=ranks_s, cold_build=built,
                                backend=ranks[0]['backend'],
                                devices=[r['device'] for r in ranks])
    for run in runs:
        label, conf = run['label'], run['config']
        f32 = _float32(conf)
        torch.cuda.reset_peak_memory_stats()
        one = Trainer(params, conf, seed=seed, lr=cfg.TRAIN_LEARNING_RATE)
        p0 = {n: p.detach().clone() for n, p in one.model.named_parameters()
              if p.requires_grad}
        m = {k: float(v) for k, v in one.step(batch).items()}
        update = torch.sqrt(sum((p.detach() - p0[n]).norm() ** 2
                                for n, p in one.model.named_parameters()
                                if n in p0)).item()
        # every rank holds the parameters of the one-process step, and
        # the ranks hold the same ones
        worst = 0.0
        for r, rank in enumerate(ranks):
            dp = rank['runs'][label]
            for n, p in one.model.named_parameters():
                if n in p0:
                    gap = (torch.from_numpy(dp['params'][n]).to(DEV)
                           - p.detach()).norm().item() / max(update, 1e-30)
                    worst = max(worst, gap)
            if worst > (GRAD_RTOL if f32 else GRAD_TOL_BF16):
                fail(f'{label} data-parallel step: rank {r}\'s parameters '
                     f'{worst:.3e} of the step\'s update from the '
                     'one-process step\'s')
        sums = [rank['runs'][label]['param_abs_sum'] for rank in ranks]
        if abs(sums[1] - sums[0]) > 1e-12 * abs(sums[0]):
            fail(f'{label} data-parallel step: the ranks\' parameters '
                 f'differ (absolute sums {sums})')
        for r in ranks:
            got = r['runs'][label]
            for k in (*LOSSES, 'loss'):
                a, b = got['metrics'][k], m[k]
                ok = (abs(a - b) <= LOSS_RTOL * abs(b) if f32
                      else abs(a - b) <= PATH_TOL_BF16 * (1 + abs(b)))
                if not ok:
                    fail(f'{label} data-parallel step {k}: rank {a}, one '
                         f'process {b}')
            if got['metrics']['skipped'] != 0.0 or got['metrics'][
                    'fg_cnt'] != m['fg_cnt']:
                fail(f'{label}: rank metrics {got["metrics"]}, one process '
                     f'{m}')
            k1 = 'cisa_shots' + ('' if f32 else '_bf16')
            roi = 'roi_align_pw' if f32 else 'roi_align_fwd_bf16'
            counts = got['launches']
            if counts[k1] != 3 or counts[roi] != 1 or counts['nms'] != 1 \
                    or sum(v for k, v in counts.items()
                           if not k.endswith('_by_device')) != 5:
                fail(f'{label}: a rank launched {counts}; expected 3 {k1}, '
                     f'1 {roi} and 1 nms')
        one_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.step(batch)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
        one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        by_path[f'dp_{label}_training'] = launch_counts(**{
            k: sum(r['runs'][label]['launches'][k] for r in ranks)
            for k in (('cisa_shots', 'roi_align_pw', 'nms') if f32 else
                      ('cisa_shots_bf16', 'roi_align_fwd_bf16', 'nms'))})
        summary[label] = dict(
            step_ms=[r['runs'][label]['step_ms'] for r in ranks],
            one_process_step_ms=one_ms,
            peak_gib=[r['runs'][label]['peak_gib'] for r in ranks],
            metrics=ranks[0]['runs'][label]['metrics'], one_process=m,
            param_rel_diff=worst,
            launches=[r['runs'][label]['launches'] for r in ranks])
        print(f'{label} data-parallel step ({card}, '
              f'{torch.cuda.device_count()} device(s) seen, '
              f'{summary["backend"]} over {summary["devices"]}): 2 ranks x 2 '
              f'episodes, ms per step by rank {summary[label]["step_ms"]}, '
              f'one process x 4 episodes {one_ms}; peak GiB by rank '
              f'{summary[label]["peak_gib"]}, one process {one_peak:.2f}; '
              f'losses equal the one-process step\'s, both ranks\' '
              f'parameters within {worst:.3e} of its update and equal to '
              f'each other; launches by rank '
              f'{summary[label]["launches"]}', flush=True)
        del one
        torch.cuda.empty_cache()
    print(f'data-parallel ranks took {ranks_s:.1f} s, the kernels built '
          f'cold by both at once: {built}', flush=True)
    return by_path, summary


def cli_rank_main(which, argv):
    """A rank of phase 13 (c): the CLI's main on argv, then its launches
    by kernel as the last line of its output."""
    from dana_tpu_torch import inference, train
    zero_launches()
    out = (train if which == 'train' else inference).main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    steps = sum(e['steps'] for e in out['epochs']) \
        if which == 'train' and out else None
    print(json.dumps({'launches': read_launches(), 'by_device': _by_device(),
                      'steps': steps}), flush=True)


def dist_cli_path(seed, card, tmp):
    """Phase 13 (c): the training CLI with --mGPUs --dist as 2 processes
    for an epoch of synth_test (5 steps of 4 episodes), then the dataset
    CLI with --dist as 2 processes serving its checkpoint over synth_test,
    against the one-process dataset CLI on the same checkpoint (detections
    tie-aware).  -> ({path: launches}, summary)."""
    from dana_tpu_torch import inference
    from dana_tpu_torch.data.synth import synth_fsod
    synth_fsod('test', num_images=20)
    synth_fsod('train')
    me = os.path.abspath(__file__)
    save = os.path.join(tmp, 'run_dp')
    t0 = time.perf_counter()
    outs = run_children([[sys.executable, me, '--cli_rank', 'train',
                          '--dataset', 'synth_test', '--way', '2', '--shot',
                          '3', '--bs', str(TRAIN_BATCH), '--epochs', '1',
                          '--nw', '4', '--dlog', '--disp_interval', '5',
                          '--seed', str(seed), '--save_dir', save,
                          '--mGPUs', '--dist', '--coordinator',
                          f'file://{tmp}/train_rdzv', '--num_procs', '2',
                          '--proc_id', str(r)] for r in (0, 1)], tmp,
                        'train_rank')
    train_s = time.perf_counter() - t0
    train_counts = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    steps = train_counts[0]['steps']
    for c in train_counts:
        if c['steps'] != steps or c['launches'] != launch_counts(
                cisa_shots=3 * steps, roi_align_pw=steps, nms=steps):
            fail(f'--dist training rank: {c}, expected 3 K1, 1 K3 and 1 '
                 f'NMS for each of {steps} steps')
    ckpts = [os.path.join(dp, f) for dp, _, fs in os.walk(save)
             for f in fs if f.endswith('.dkpt')]
    if len(ckpts) != 1:
        fail(f'--dist training wrote {ckpts}, expected the chief\'s one')
    argv = ['--dataset', 'synth', '--way', '2', '--shot', '3', '--bs',
            str(BATCH), '--seed', str(seed), '--checkpath', ckpts[0]]
    one_dir, pair_dir = os.path.join(tmp, 'eval_one'), os.path.join(
        tmp, 'eval_dp')
    inference.main(argv + ['--eval_dir', one_dir])
    t0 = time.perf_counter()
    outs = run_children([[sys.executable, me, '--cli_rank', 'inference',
                          *argv, '--eval_dir', pair_dir, '--dist',
                          '--coordinator', f'file://{tmp}/eval_rdzv',
                          '--num_procs', '2', '--proc_id', str(r)]
                         for r in (0, 1)], tmp, 'eval_rank')
    eval_s = time.perf_counter() - t0
    eval_counts = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    chunks = []
    for r, o in enumerate(outs):
        hit = re.search(rf'^rank {r}: (\d+) of the chunks', o, re.M)
        chunks.append(int(hit.group(1)) if hit else None)
    for c, n in zip(eval_counts, chunks):
        if n is None or c['launches'] != launch_counts(
                cisa_shots=2 * n, roi_align_fwd=n, nms=2 * n):
            fail(f'--dist eval rank: {c}, expected 2 K1, 1 K2 and 2 NMS '
                 f'for each of its {n} chunks')
    with open(os.path.join(one_dir, 'detections.pkl'), 'rb') as f:
        one = pickle.load(f)
    with open(os.path.join(pair_dir, 'detections.pkl'), 'rb') as f:
        pair = pickle.load(f)
    cells = 0
    for ca, cb in zip(one, pair):
        for da, db in zip(ca, cb):
            if isinstance(da, np.ndarray) and len(da):
                match_detections(da, db, coord_atol=BOX_ATOL)
                cells += 1
            elif isinstance(db, np.ndarray) and len(db):
                fail('--dist eval detected where one process did not')
    by_path = {f'dist_train_rank{r}': c['launches']
               for r, c in enumerate(train_counts)}
    by_path.update({f'dist_eval_rank{r}': c['launches']
                    for r, c in enumerate(eval_counts)})
    summary = dict(train_s=train_s, steps=steps, eval_s=eval_s,
                   chunks=chunks, cells=cells,
                   train_launches=train_counts, eval_launches=eval_counts)
    print(f'--dist CLIs ({card}): training 2 ranks x {steps} steps in '
          f'{train_s:.1f} s, launches by rank {train_counts}; dataset CLI 2 '
          f'ranks ({chunks} chunks) in {eval_s:.1f} s, launches by rank '
          f'{eval_counts}; merged detections equal the one-process run\'s '
          f'in {cells} cells (tie-aware)', flush=True)
    return by_path, summary


# phase 13 (d): int8 on the grids, each against the one-device int8
# request: label -> (TPU.QUANT_SCOPE, the Predictor's grid keywords)
def int8_grid_modes():
    data = grid_devices(max(2, torch.cuda.device_count()))
    return {'mGPUs_int8_tail': ('tail', dict(devices=data)),
            'mGPUs_int8_all': ('all', dict(devices=data)),
            'sp2_int8_all': ('all', dict(devices=grid_devices(2), sp=2))}


# a row's activation scale against the one-device request's, relative: the
# float trunk under 'tail' runs cuDNN on each row's batch, whose sums may
# take another order than on the whole batch
SCALE_RTOL = 1e-5
LAYER4_INT8_CONVS = 10      # layer4's, on each data row's first device


@contextlib.contextmanager
def recorded_scales(record):
    """Every int8 conv's activation scale while the block runs, in call
    order: record[row] for the calling thread's ScaleGroup row, or
    record[None] outside a group (one device, and a row's spatial
    blocks)."""
    from dana_tpu_torch.models import layers as L
    real, lock = L.quantize_activation, threading.Lock()

    def quantize(x, amax=None):
        xq, sx = real(x, amax)
        with lock:
            record.setdefault(L.scale_group_row(), []).append(sx)
        return xq, sx
    L.quantize_activation = quantize
    try:
        yield
    finally:
        L.quantize_activation = real


def timed_requests(pred, requests, label):
    """Each request served and timed (host clock to a synchronise) ->
    ms per request; fails on detections of another shape or not finite."""
    req_ms = []
    for query, info, classes in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets, valid = pred.predict(query, info, classes)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        if dets.shape != (BATCH, 100, 5) or not torch.isfinite(dets).all():
            fail(f'{label}: bad detections {tuple(dets.shape)}')
    return req_ms


def int8_grid_path(seed, card, float_grids):
    """Phase 13 (d): phase 4's detector quantized (scope 'tail' and 'all')
    on the --mGPUs grid, and 'all' at sp=2, each serving REQUESTS requests
    timed beside the one-device int8 predictor's in this call (and the
    float32 grid's of (a)), the kernels and the int8 products counted by
    device; request 0 against the one-device request: every int8 conv's
    activation scale on every row beside the one-device scale (within
    SCALE_RTOL; under sp the blocks' scales equal); on the data rows the
    RPN outputs and heads at TOL on the one-device request's proposals and
    the detections tie-aware at BOX_ATOL (`compare_grid`, phase 4's
    tolerances), under sp the outputs bit for bit.  -> ({path: launches},
    summary)."""
    from dana_tpu_torch import quant
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    conf = dataclasses.replace(config, roi_align_int8=True)
    requests = serving_requests(seed, REQUESTS)
    by_path, summary, ones = {}, {}, {}
    for label, (scope, kw) in int8_grid_modes().items():
        tree = quant.quantize_params(params, scope)
        if scope not in ones:
            one = serving_predictor(seed, (conf, tree))
            ones[scope] = (one, timed_requests(one, requests, scope))
        one, one_ms = ones[scope]
        pred = serving_predictor(seed, (conf, tree), **kw)
        zero_launches()
        req_ms = timed_requests(pred, requests, label)
        launches, by_dev = read_launches(), _by_device()
        rows, blocks = len(pred.rows), kw.get('sp', 1)
        trunk = INT8_CONVS[scope][0] - LAYER4_INT8_CONVS
        convs = rows * (LAYER4_INT8_CONVS + trunk * blocks)
        want = launch_counts(cisa_shots=2 * rows * REQUESTS,
                             roi_align_fwd=rows * REQUESTS,
                             nms=2 * rows * REQUESTS,
                             int8_conv=convs * REQUESTS,
                             int_mm=convs * REQUESTS)
        if launches != want:
            fail(f'{label} launches {launches}, expected {want}')
        want_dev = {name: collections.Counter() for name in
                    ('cisa_shots', 'roi_align_fwd', 'nms', 'int_mm')}
        for row in pred.rows:
            lead = str(row.lead)
            for name, per in (('cisa_shots', 2), ('roi_align_fwd', 1),
                              ('nms', 2), ('int_mm', LAYER4_INT8_CONVS)):
                want_dev[name][lead] += per * REQUESTS
            for d in (row.devices if blocks > 1 else [row.lead]):
                want_dev['int_mm'][str(d)] += trunk * REQUESTS
        for name, per_dev in want_dev.items():
            got = {k.split('/')[0]: v for k, v in by_dev[name].items()}
            if got != {d: n for d, n in per_dev.items() if n}:
                fail(f'{label} {name} launches by device {got}, expected '
                     f'{dict(per_dev)}')
        one_sc, grid_sc = {}, {}
        if blocks > 1:
            with recorded_scales(one_sc):
                want_out = one.forward(*requests[0])
                want_det = one.predict(*requests[0])
            with recorded_scales(grid_sc):
                got_out = pred.forward(*requests[0])
                got_det = pred.predict(*requests[0])
            exact = all(torch.equal(got_out[k], want_out[k])
                        for k in want_out) and all(
                torch.equal(a, b) for a, b in zip(got_det, want_det))
            if not exact:
                fail(f'{label}: request 0 differs from the one-device int8 '
                     'request (expected bit for bit)')
            seq = [float(t) for t in grid_sc[None]]
            n_trunk = trunk * blocks
            if seq[:n_trunk:2] != seq[1:n_trunk:2]:
                fail(f'{label}: the spatial blocks took different scales')
            row_scales = {0: seq[:n_trunk:2] + seq[n_trunk:]}
            one_scales = [float(t) for t in one_sc[None]]
            diffs = dict(bit_for_bit=True)
        else:
            # the one-device request records outside a ScaleGroup, the
            # rows inside it
            with recorded_scales(grid_sc):
                diffs = compare_grid(pred, one, *requests[0], label=label)
            one_scales = [float(t) for t in grid_sc[None]]
            row_scales = {r: [float(t) for t in grid_sc[r]]
                          for r in range(rows)}
        n = INT8_CONVS[scope][0]
        one_scales = one_scales[:n]
        worst = 0.0
        for r, sc in row_scales.items():
            sc = sc[:n]
            if len(sc) != n or len(one_scales) != n:
                fail(f'{label} row {r}: {len(sc)} int8 conv scales, the '
                     f'one-device request {len(one_scales)}, expected {n}')
            worst = max(worst, max(abs(a - b) / b
                                   for a, b in zip(sc, one_scales)))
            print(f'{label} row {r} scales (one device | this row): '
                  + ' '.join(f'{b:.7g}|{a:.7g}'
                             for a, b in zip(sc, one_scales)), flush=True)
        if worst > SCALE_RTOL:
            fail(f'{label}: a row\'s activation scale is {worst:.3e} '
                 f'(relative) from the one-device request\'s, past '
                 f'{SCALE_RTOL}')
        float_ms = float_grids.get('sp2' if blocks > 1 else 'mGPUs',
                                   {}).get('req_ms')
        by_path[f'{label}_serving'] = launches
        summary[label] = dict(
            grid=repr(pred.grid), devices=[str(d) for d in kw['devices']],
            req_ms=req_ms, one_device_int8_req_ms=one_ms,
            float32_grid_req_ms=float_ms, by_device=by_dev,
            path_diffs=diffs, scale_max_rel_diff=worst,
            scales={'one_device': one_scales, 'rows': row_scales})
        print(f'{label} ({card}, {torch.cuda.device_count()} device(s) '
              f'seen): {pred.grid} over {[str(d) for d in kw["devices"]]}, '
              f'ms per request {req_ms} (one-device int8 {scope} in this '
              f'call: {one_ms}; float32 on this grid, (a): {float_ms}), '
              f'launches by device {by_dev}; request 0 against the '
              f'one-device int8 request: {diffs}, scales within {worst:.3e} '
              '(relative)', flush=True)
        del pred
        torch.cuda.empty_cache()
    return by_path, summary


def parallel_path(seed, card):
    """Phase 13: (a) grid_serving_path, (b) dp_step_path, (c)
    dist_cli_path, (d) int8_grid_path.  -> ({path: launches}, summary)."""
    by_path, summary = {}, {}
    t0 = time.perf_counter()
    part, summary['serving'] = grid_serving_path(seed, card)
    by_path.update(part)
    summary['serving_s'] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    part, summary['int8_grids'] = int8_grid_path(seed, card, summary[
        'serving'])
    by_path.update(part)
    summary['int8_grids_s'] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        part, summary['dp_step'] = dp_step_path(seed, card, tmp)
        by_path.update(part)
        summary['dp_step_s'] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        part, summary['dist_cli'] = dist_cli_path(seed, card, tmp)
        by_path.update(part)
        summary['dist_cli_s'] = time.perf_counter() - t1
    summary['phase_s'] = time.perf_counter() - t0
    return by_path, summary


# --------------------------------------------------------------- phase 14

# int8 serving (dana_tpu_torch/quant.py): label -> (TPU.QUANT_SCOPE, the
# precision fields of the DanaConfig)
INT8 = {'tail_float32': ('tail', {}),
        'tail_default_recipe': ('tail', dict(
            compute_dtype=torch.bfloat16, **PRECISION['default_recipe'])),
        'all_float32': ('all', {})}
# the int8 convs of ResNet-50 a scope quantizes, and of them those of the
# support trunk (conv1..layer3), which `encode_supports` runs once a class
INT8_CONVS = {'tail': (10, 0), 'all': (53, 43)}
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
INT8_CLI_LINE = 'int8-quantized 10 convs (scope=tail) + int8 roi_align'


def identity_bn_exact(dev):
    """The identity BN entries of quant.py through the frozen BN on the
    card: x back bit for bit, in float32 and in bf16."""
    from dana_tpu_torch import quant
    from dana_tpu_torch.models import layers as L
    bn = L.FrozenBatchNorm2d(64).to(dev)
    for k, v in quant._identity_bn(64).items():
        getattr(bn, k).copy_(torch.from_numpy(v))
    x = torch.randn(8, 64, 9, 11, device=dev) * 30
    for dt in (torch.float32, torch.bfloat16):
        if not torch.equal(bn(x.to(dt)), x.to(dt)):
            fail(f'the identity BatchNorm is not exact on the card in {dt}')


def detection_shift(got, want):
    """How far one request's detections `got` (dets, valid) are from
    `want`: per image the counts, and over all images the mean IoU of each
    of want's detections with its best match in got and the mean |score
    difference| of those matches."""
    from dana_tpu_torch.core.boxes import iou_matrix
    (dg, vg), (dw, vw) = ([x.cpu() for x in d] for d in (got, want))
    counts, ious, dscore = [], [], []
    for i in range(len(dg)):
        a, b = dg[i][vg[i]], dw[i][vw[i]]
        counts.append((len(a), len(b)))
        if len(a) and len(b):
            iou = iou_matrix(b[:, :4], a[:, :4])
            best, j = iou.max(1)
            ious.append(best.mean().item())
            dscore.append((b[:, 4] - a[j, 4]).abs().mean().item())
    return dict(counts=counts, mean_best_iou=float(np.mean(ious)),
                mean_score_diff=float(np.mean(dscore)))


def layer4_int8_convs(seed, card):
    """layer4's ten convs at the serving shapes (BATCH x 300 rois of 7x7x1024
    pooled features) as `torch._int_mm` products (the NHWC patches and the
    product, `int8_conv_acc`), as whole int8 convs (the activation's
    quantization, the product and the rescale) and as cuDNN convs of the
    same shapes in float32 (no TF32) and bf16, each timed by CUDA events
    beside the product's bound at INT8_OPS_PER_S; then layer4 with its
    spatial mean whole, float32 against int8 against bf16.  -> summary."""
    import torch.nn.functional as F
    from dana_tpu_torch import quant
    from dana_tpu_torch.models import layers as L
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    bb = from_jax_params(params, config).backbone.to(DEV)
    qbb = from_jax_params(quant.quantize_params(params, 'tail'),
                          config).backbone.to(DEV)
    n = BATCH * config.test_post_nms
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rows, totals = {}, dict(int_mm_ms=0.0, int8_conv_ms=0.0, f32_ms=0.0,
                            bf16_ms=0.0, bound_ms=0.0)
    with torch.inference_mode():
        for name, q in qbb.layer4.named_modules():
            if not isinstance(q, L.QuantConv2d):
                continue
            f = bb.layer4.get_submodule(name)
            cin = q.w_int8.shape[1]
            hw = 7 if name in ('0.conv1', '0.downsample.0') else 4
            x = torch.randn(n, hw, hw, cin, device=DEV, generator=gen) \
                .abs().permute(0, 3, 1, 2)
            xq, _ = L.quantize_activation(x)
            o, _, kh, _ = q.w_int8.shape
            ho = (hw + 2 * q.padding - kh) // q.stride + 1
            m, k = n * ho * ho, cin * kh * kh
            b_ms, b_by = bound_ms(m * k + k * o + 4 * m * o, 2 * m * k * o,
                                  INT8_OPS_PER_S)
            xb, wb = x.to(torch.bfloat16), f.weight.to(torch.bfloat16)
            row = dict(
                m=m, k=k, n=o,
                int_mm_ms=cuda_ms(lambda: L.int8_conv_acc(
                    xq, q.w_int8, q.stride, q.padding), 10),
                int8_conv_ms=cuda_ms(lambda: q(x), 10),
                f32_ms=cuda_ms(lambda: F.conv2d(
                    x, f.weight, None, f.stride, f.padding), 10),
                bf16_ms=cuda_ms(lambda: F.conv2d(
                    xb, wb, None, f.stride, f.padding), 10),
                bound_ms=b_ms, bound_by=b_by)
            row['int_mm_tops'] = 2 * m * k * o / row['int_mm_ms'] / 1e9
            rows[name] = row
            for key in totals:
                totals[key] += row[key]
        pooled = torch.randn(n, 7, 7, 1024, device=DEV, generator=gen).abs()
        tail = dict(f32_ms=cuda_ms(lambda: bb.tail(pooled), 5),
                    int8_ms=cuda_ms(lambda: qbb.tail(pooled), 5),
                    bf16_ms=cuda_ms(lambda: bb.tail(
                        pooled.to(torch.bfloat16)), 5))
    for name, row in rows.items():
        print(f'layer4 {name} [{row["m"]} x {row["k"]}] x [{row["k"]} x '
              f'{row["n"]}] ({card}): _int_mm {row["int_mm_ms"]:.4f} ms '
              f'({row["int_mm_tops"]:.1f} TOPS), whole int8 conv '
              f'{row["int8_conv_ms"]:.4f}, cuDNN float32 '
              f'{row["f32_ms"]:.4f}, bf16 {row["bf16_ms"]:.4f}, bound '
              f'{row["bound_ms"]:.4f} ({row["bound_by"]})', flush=True)
    print(f'layer4 convs summed ({card}): {totals}; layer4 with its mean '
          f'on {n} rois: {tail} ms', flush=True)
    return dict(convs=rows, totals=totals, tail=tail)


def int8_path(seed, card, f32_serving, f32_dets, recipe_serving, cli,
              checkpath):
    """Phase 14: phase 4's detector quantized (INT8) serves REQUESTS
    requests per setting as phase 4 does, the int8 counters zeroed around
    each: K1 2 a request, K2 1 on a float32 map (the int8 RoIAlign in its
    place on a bf16 map, K2-bf16 never), the scope's int8 convs, one
    `torch._int_mm` per conv and per image of the int8 RoIAlign; the two
    classes' supports encoded under the same counters (INT8_CONVS); request
    0 against the plain path (float64 int8 products) at phase 4's and
    phase 10's tolerances; its detections' distance from phase 4's float32
    ones printed.  Then layer4's convs timed (`layer4_int8_convs`) and the
    dataset CLI with TPU.QUANT_INT8 over synth_test on phase 7's
    checkpoint (JAX's line; its AP beside phase 6's).  -> ({path:
    launches}, summary)."""
    from dana_tpu_torch import quant
    from dana_tpu_torch.utils import config as cfg
    t0 = time.perf_counter()
    identity_bn_exact(DEV)
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    by_path, summary = {}, {}
    for label, (scope, fields) in INT8.items():
        conf = dataclasses.replace(config, roi_align_int8=True, **fields)
        per_request, per_class = INT8_CONVS[scope]
        zero_launches()
        pred = serving_predictor(seed, (conf, quant.quantize_params(
            params, scope)))
        enc = read_launches()
        if (enc['int8_conv'], enc['int_mm']) != (2 * per_class,) * 2 \
                or quant.count_int8(pred.model) != per_request:
            fail(f'int8 {label}: {quant.count_int8(pred.model)} int8 convs '
                 f'and {enc} at encode_supports of 2 classes, expected '
                 f'{per_request} and {per_class} a class')
        keep = {}
        tol = TOL if conf.compute_dtype == torch.float32 else PATH_TOL_BF16
        by_path[f'int8_{label}'], summary[label] = serving_path(
            seed, label=f'int8 {label}', tol=tol, pred=pred, keep=keep)
        del pred
        torch.cuda.empty_cache()
        shift = detection_shift(keep['dets'], f32_dets)
        summary[label]['shift_from_float32'] = shift
        base = recipe_serving if fields else f32_serving
        print(f'int8 {label} ({card}): ms per request '
              f'{summary[label]["req_ms"]} (unquantized, phase '
              f'{10 if fields else 4}: {base["req_ms"]}), peak memory '
              f'{summary[label]["peak_gib"]:.2f} GiB (unquantized '
              f'{base["peak_gib"]:.2f}); request 0 against phase 4\'s '
              f'float32 detections: {shift} (printed, not judged)',
              flush=True)
    summary['layer4'] = layer4_int8_convs(seed, card)
    torch.cuda.empty_cache()
    by_path['int8_cli'], summary['cli'] = cli_path(
        seed, checkpath, ('TPU.QUANT_INT8', 'True'), label='int8 CLI path',
        int8_convs=INT8_CONVS['tail'][0])
    if summary['cli']['lines'] != [INT8_CLI_LINE]:
        fail(f'int8 CLI printed {summary["cli"]["lines"]}, expected '
             f'[{INT8_CLI_LINE!r}]')
    print(f'dataset CLI over synth_test with TPU.QUANT_INT8: AP '
          f'{summary["cli"]["stats"][0]:.4f}, '
          f'{summary["cli"]["img_per_s"]:.2f} img/s; float32 (phase 6): AP '
          f'{cli["stats"][0]:.4f}, {cli["img_per_s"]:.2f} img/s (AP not '
          'judged)', flush=True)
    summary['phase_s'] = time.perf_counter() - t0
    return by_path, summary


# --------------------------------------------------------------- phase 15

# phase 15: an artifact's detections against the live predictor's on the
# same features and queries, phase 4's tolerance (phase 10's in the recipe)
EXPORT_TOL = {'float32': TOL, 'default_recipe': PATH_TOL_BF16,
              'int8_tail': TOL, 'seed1': TOL, 'cardless_float32': TOL,
              'cardless_int8_tail': TOL}
# exported by a process that sees no card (CUDA_VISIBLE_DEVICES=''), served
# on the card bit for bit
CARDLESS = ('cardless_float32', 'cardless_int8_tail')


def export_child_main(out_dir, seed):
    """Phase 15's exporting process, which sees no card: phase 4's float32
    detector and its int8 'tail' form exported for the card at QUERY_HW
    (dana_tpu_torch/serve.py traces on the CPU and places the programs on
    cuda:0) into out_dir/<label>; prints each export's seconds and the
    devices its predict program names."""
    from dana_tpu_torch import quant, serve
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    if torch.cuda.is_available():
        fail('the exporting process sees a card')
    config, params = cfg.get_model('res50', way=2, shot=3, seed=int(seed))
    conf_q = dataclasses.replace(config, roi_align_int8=True)
    report = {}
    for label, conf, tree in (
            (CARDLESS[0], config, params),
            (CARDLESS[1], conf_q, quant.quantize_params(params, 'tail'))):
        t0 = time.perf_counter()
        out = os.path.join(out_dir, label)
        meta = serve.export_predictor(
            from_jax_params(tree, conf), conf, out, buckets=(QUERY_HW,),
            batch_size=BATCH, sup_size=SUPPORT_HW, device='cuda')
        secs = time.perf_counter() - t0
        ep = torch.export.load(os.path.join(out, meta['buckets'][0]['file']))
        report[label] = dict(export_s=secs, device=meta['device'],
                             quantized=meta['quantized'],
                             program_devices=sorted(
                                 serve.program_devices(ep)))
    print(json.dumps(report), flush=True)


def serve_child_main(job_path):
    """Phase 15's serving process: imports `dana_tpu_torch.serve` and
    never the model code, loads each job's artifact and weights (a state
    dict saved by the parent), encodes the job's supports with the
    artifact's encoder and serves its requests (each query's row of the
    support features assembled from the parent's per-class features: its
    class first), each once untimed, then again timed, counting the
    kernels' launches and NMS's host syncs around the timed requests;
    writes the results beside the job file."""
    from dana_tpu_torch import serve
    jobs = torch.load(job_path)
    results, loaded = {}, {}
    for job in jobs:
        t0 = time.perf_counter()
        if job['dir'] not in loaded:
            loaded[job['dir']] = serve.load(job['dir'])
        pred = loaded[job['dir']]
        load_s = time.perf_counter() - t0
        params = torch.load(job['weights'], map_location=pred.device)
        enc = pred.encode(params, job['sup'])
        feats = {c: tuple(t.to(pred.device) for t in f)
                 for c, f in job['class_feats'].items()}
        reqs = []
        for im, info, classes in job['requests']:
            rows = [tuple(torch.cat([feats[c][j], *(feats[o][j]
                                                    for o in feats
                                                    if o != c)], 1)
                          for j in range(2)) for c in classes]
            reqs.append((im, info, torch.cat([r[0] for r in rows]),
                         torch.cat([r[1] for r in rows])))
        for req in reqs:                  # each program's first call, untimed
            pred(params, *req)
        sync = torch.cuda.synchronize if pred.device.type == 'cuda' \
            else (lambda: None)
        zero_launches()
        outs, req_ms = [], []
        for req in reqs:
            sync()
            t0 = time.perf_counter()
            dets, valid = pred(params, *req)
            sync()
            req_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append((dets.cpu(), valid.cpu()))
        counted = read_launches()
        launches = {}
        for name in ('cisa_shots', 'roi_align_fwd', 'nms', 'int_mm'):
            launches[name] = counted[name]
            launches[name + '_bf16'] = counted.get(name + '_bf16', 0)
        results[job['label']] = dict(
            outs=outs, req_ms=req_ms, load_s=load_s, launches=launches,
            host_syncs=nms_syncs(), meta=pred.meta,
            encoded=tuple(t.cpu() for t in enc))
    results['models_imported'] = 'dana_tpu_torch.models' in sys.modules
    torch.save(results, job_path + '.out')
    print(json.dumps({'jobs': [j['label'] for j in jobs],
                      'models_imported': results['models_imported']}),
          flush=True)


def serving_export_path(seed, card, f32_serving):
    """Phase 15: phase 4's float32 DAnA exported at the five buckets
    (dana_tpu_torch/serve.py), plus the default recipe and int8 'tail',
    each at the first bucket, and the float32 and int8 'tail' ones again
    from a process that sees no card (`export_child_main`); every artifact
    served in one fresh process (`serve_child_main`)
    against the live Predictor on the same supports (its per-class
    features) and the same queries (phase 4's uint8 requests, mean
    subtracted to float32 as the artifacts take them), a second seed's
    weights through the first artifact; the card-less exports bit for bit,
    and the card-less float32 artifact against the one exported here.
    Both sides time each request after an untimed first call of its
    program.  -> ({path: launches}, summary)."""
    from dana_tpu_torch import quant, serve
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    t_phase = time.perf_counter()
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    means = np.asarray(cfg.PIXEL_MEANS, np.float32)
    rng = np.random.default_rng(seed)
    sups = [rng.integers(0, 256, (config.n_shot, SUPPORT_HW, SUPPORT_HW,
                                  3)).astype(np.float32) - means
            for _ in range(2)]
    sup6 = torch.from_numpy(np.concatenate(sups)[None])
    main_reqs = [(torch.from_numpy(q.astype(np.float32) - means),
                  torch.from_numpy(info), classes)
                 for q, info, classes in serving_requests(seed, REQUESTS)]
    qrng = np.random.default_rng(seed + 5)
    other_reqs = [(torch.from_numpy(qrng.integers(
        0, 256, (BATCH, h, w, 3)).astype(np.float32) - means),
        torch.tensor([[h, w, 1.0]] * BATCH), [j % 2 for j in range(BATCH)])
        for h, w in OTHER_BUCKETS]
    summary, jobs, live = {}, [], {}
    with tempfile.TemporaryDirectory() as tmp:
        def export(label, model, conf, buckets, **kw):
            out_dir = os.path.join(tmp, label)
            t0 = time.perf_counter()
            meta = serve.export_predictor(model, conf, out_dir,
                                          buckets=buckets, batch_size=BATCH,
                                          sup_size=SUPPORT_HW, device=DEV,
                                          **kw)
            secs = time.perf_counter() - t0
            sizes = {f: os.path.getsize(os.path.join(out_dir, f))
                     for f in sorted(os.listdir(out_dir))}
            wbytes = sum(v.numel() * v.element_size()
                         for v in model.state_dict().values())
            if max(sizes.values()) >= wbytes / 10:
                fail(f'{label} artifact: a file of {max(sizes.values())} '
                     f'bytes against {wbytes} bytes of weights')
            summary[label] = dict(export_s=secs, bytes=sizes,
                                  weights_bytes=wbytes,
                                  quantized=meta['quantized'])
            print(f'{label}: exported {len(buckets)} buckets and the encoder '
                  f'in {secs:.1f} s: {sum(sizes.values())} bytes in all, '
                  f'largest file {max(sizes.values())} against {wbytes} '
                  f'bytes of weights', flush=True)
            return out_dir, meta

        def live_run(label, pred, reqs, weights_file, out_dir):
            """The live Predictor's detections and times on `reqs`, and the
            job that serves them from `out_dir` with the same features."""
            class_feats = {c: tuple(t.cpu() for t in
                                    pred.batch_support_feats([c]))
                           for c in (0, 1)}
            outs, req_ms = [], []
            for req in reqs:              # each bucket's first call, untimed
                pred.predict(*req)
            for im, info, classes in reqs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets, valid = pred.predict(im, info, classes)
                torch.cuda.synchronize()
                req_ms.append((time.perf_counter() - t0) * 1e3)
                outs.append((dets.cpu(), valid.cpu()))
            live[label] = dict(outs=outs, req_ms=req_ms, config=pred.config)
            jobs.append(dict(label=label, dir=out_dir, weights=weights_file,
                             sup=sup6, class_feats=class_feats,
                             requests=reqs))

        def weights(label, model):
            path = os.path.join(tmp, f'{label}.weights.pt')
            torch.save(model.state_dict(), path)
            return path

        model = from_jax_params(params, config).to(DEV)
        f32_dir, _ = export('float32', model, config,
                            (QUERY_HW, *OTHER_BUCKETS))
        w0 = weights('float32', model)
        pred = serving_predictor(seed, (config, model))
        with torch.inference_mode():
            enc_live = [t.cpu() for t in dana.extract_support_feats(
                model, config, sup6.to(DEV))]
        live_run('float32', pred, main_reqs + other_reqs, w0, f32_dir)

        conf_r = _recipe(config, 'default_recipe')
        rec_dir, _ = export('default_recipe', model, conf_r, (QUERY_HW,))
        live_run('default_recipe', serving_predictor(seed, (conf_r, model)),
                 main_reqs[:1], w0, rec_dir)

        # the card-less process exports while this one serves
        t0 = time.perf_counter()
        out = run_children([[sys.executable, os.path.abspath(__file__),
                             '--export_child', tmp, str(seed)]], tmp,
                           'export', env={'CUDA_VISIBLE_DEVICES': ''})[0]
        cardless = json.loads(out.strip().splitlines()[-1])
        for label, rep in cardless.items():
            if rep['device'] != 'cuda:0' or rep['program_devices'] != [
                    'cuda:0'] or rep['quantized'] != ('int8' in label):
                fail(f'{label} exported without a card: {rep}')
        summary['cardless_export'] = dict(cardless, process_s=(
            time.perf_counter() - t0))
        print(f'exported for the card by a process that sees none in '
              f'{summary["cardless_export"]["process_s"]:.1f} s: {cardless}',
              flush=True)
        live_run(CARDLESS[0], pred, main_reqs[:1], w0,
                 os.path.join(tmp, CARDLESS[0]))
        del pred

        conf_q = dataclasses.replace(config, roi_align_int8=True)
        model_q = from_jax_params(quant.quantize_params(params, 'tail'),
                                  conf_q).to(DEV)
        q_dir, meta_q = export('int8_tail', model_q, conf_q, (QUERY_HW,))
        if not meta_q['quantized']:
            fail('int8 tail artifact: meta.json says not quantized')
        pred_q = serving_predictor(seed, (conf_q, model_q))
        wq = weights('int8_tail', model_q)
        live_run('int8_tail', pred_q, main_reqs[:1], wq, q_dir)
        live_run(CARDLESS[1], pred_q, main_reqs[:1], wq,
                 os.path.join(tmp, CARDLESS[1]))
        del model_q, pred_q

        _, params1 = cfg.get_model('res50', way=2, shot=3, seed=seed + 1)
        model1 = from_jax_params(params1, config).to(DEV)
        live_run('seed1', serving_predictor(seed, (config, model1)),
                 main_reqs[:1], weights('seed1', model1), f32_dir)
        del model, model1
        torch.cuda.empty_cache()

        job_path = os.path.join(tmp, 'serve_jobs.pt')
        torch.save(jobs, job_path)
        t0 = time.perf_counter()
        out = run_children([[sys.executable, os.path.abspath(__file__),
                             '--serve_child', job_path]], tmp, 'serve')[0]
        child_s = time.perf_counter() - t0
        served = torch.load(job_path + '.out')
    if served.pop('models_imported'):
        fail('the serving process imported dana_tpu_torch.models')
    by_path = {}
    for label, res in served.items():
        conf, want = live[label]['config'], live[label]['outs']
        n = len(want)
        k1 = 'cisa_shots' + _suffix(conf.attention_dt)
        roi = 'roi_align_fwd' + _suffix(conf.compute_dtype)
        expect = {k: 0 for k in res['launches']}
        expect.update({k1: 2 * n, 'nms': 2 * n})
        if res['meta']['quantized']:
            expect['int_mm'] = INT8_CONVS['tail'][0] * n
        if not (conf.roi_align_int8 and conf.compute_dtype != torch.float32):
            expect[roi] = n
        if res['launches'] != expect or res['host_syncs']:
            fail(f'{label} artifact served with launches {res["launches"]} '
                 f'and {res["host_syncs"]} NMS host syncs, expected '
                 f'{expect} and none')
        by_path[f'export_{label}'] = launch_counts(**{
            k: v for k, v in res['launches'].items() if v})
        exact = True
        for i, ((dk, vk), (dl, vl)) in enumerate(zip(res['outs'], want)):
            exact &= torch.equal(dk, dl) and torch.equal(vk, vl)
            if dk.shape != dl.shape or not torch.isfinite(dk).all() \
                    or not torch.equal(vk.sum(1), vl.sum(1)):
                fail(f'{label} artifact request {i}: {vk.sum(1).tolist()} '
                     f'detections per image against the live predictor\'s '
                     f'{vl.sum(1).tolist()}')
            for j in range(len(dk)):
                match_detections(dk[j][vk[j]].numpy(), dl[j][vl[j]].numpy(),
                                 coord_atol=BOX_ATOL,
                                 score_tol=EXPORT_TOL[label])
        summary.setdefault(label, {}).update(
            req_ms=res['req_ms'], live_req_ms=live[label]['req_ms'],
            load_s=res['load_s'], launches=res['launches'],
            bit_for_bit=bool(exact))
        print(f'{label} artifact in a fresh process ({card}): '
              f'{n} requests, ms per request {res["req_ms"]} (live predictor '
              f'in this call: {live[label]["req_ms"]}), loaded in '
              f'{res["load_s"]:.1f} s, launches {res["launches"]}, NMS host '
              f'syncs 0; detections == live (tie-aware at '
              f'{EXPORT_TOL[label]}), bit for bit: {exact}', flush=True)
    # the artifacts exported without a card: bit for bit against the live
    # predictor, and the float32 one against the one exported here
    for label in CARDLESS:
        if not summary[label]['bit_for_bit']:
            fail(f'{label} artifact: not bit for bit against the live '
                 'predictor')
    (dc, vc), (dk, vk) = (served[k]['outs'][0]
                          for k in (CARDLESS[0], 'float32'))
    if not (torch.equal(dc, dk) and torch.equal(vc, vk)):
        fail('the float32 artifact exported without a card differs from '
             'the one exported on this host')
    print('the artifacts exported without a card serve bit for bit against '
          'the live predictor, and the float32 one equals the one exported '
          'on this host on request 0', flush=True)
    enc = served['float32']['encoded']
    enc_err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(enc, enc_live))
    if enc_err > TOL:
        fail(f'the encoder artifact differs from the live encoder by '
             f'{enc_err:.3e}')
    summary['encoder_max_abs_err'] = enc_err
    summary['child_s'] = child_s
    summary['phase_s'] = time.perf_counter() - t_phase
    print(f'encoder artifact == live encoder within {enc_err:.3e}; the '
          f'serving process took {child_s:.1f} s: {out.strip()}; phase 4 '
          f'served its uint8 requests in {f32_serving["req_ms"]} ms',
          flush=True)
    return by_path, summary


# --------------------------------------------------------------- phase 16

# the dataset CLI's --set for the space-to-depth stem
S2D_SET = ('TPU.STEM_S2D', 'True')
HOST_ITERS = 5                # timed passes of each host pack, median kept
CONV1_ITERS = 20


def s2d_requests(requests):
    """`serving_requests`' requests with their uint8 queries packed for
    the space-to-depth stem (data/blob.py `s2d_pack`, the rounded means as
    the border): [BATCH, H/2+3, W/2+3, 12]."""
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.utils import config as cfg
    pad = blob.u8_pad_of(cfg.PIXEL_MEANS)
    return [(blob.s2d_pack(q, u8_pad=pad), info, classes)
            for q, info, classes in requests]


def s2d_against_direct(seed, pred_d, pred_s):
    """Phase 16 (a): one request of float mean-subtracted queries through
    the direct stem (pred_d) and its packing through the space-to-depth
    stem (pred_s, the same supports packed): the trunk's features and the
    RPN's scores and deltas within TOL (1e-4 + 1e-4 |x|), the heads on
    the direct path's proposals within TOL, and the detections on those
    proposals tie-aware.  -> the max |diff| of each."""
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.models import dana, frameworks
    from dana_tpu_torch.utils import config as cfg
    config = pred_d.config
    query, info, classes = serving_requests(seed, 1)[0]
    qf = query.astype(np.float32) - np.asarray(cfg.PIXEL_MEANS, np.float32)
    qd = blob.s2d_pack(qf)
    runs = {}
    for name, pred, q in (('direct', pred_d, qf), ('s2d', pred_s, qd)):
        record = []
        pinned = None if name == 'direct' else runs['direct'][0][0][1]
        q_t = torch.as_tensor(q, device=DEV)
        with pinned_proposals(record, pinned), torch.inference_mode():
            feat = dana.query_features(pred.model, config, q_t)
            out = frameworks.forward(
                pred.model, config, q_t, torch.as_tensor(info, device=DEV),
                support_feats=pred.batch_support_feats(classes))
            if name == 'direct':
                pinned = record[0][1]
            with pinned_proposals([], pinned):
                dets = pred.predict(q, info, classes)
        runs[name] = record, feat, out, dets
    (rec_d, feat_d, out_d, dets_d), (rec_s, feat_s, out_s, dets_s) = \
        runs['direct'], runs['s2d']
    diffs = {'trunk': check_close('s2d trunk features', feat_s, feat_d)}
    for i, key in enumerate(('rpn_scores', 'rpn_deltas')):
        diffs[key] = check_close(f's2d {key}', rec_s[0][0][i],
                                 rec_d[0][0][i])
    for key in ('cls_prob', 'bbox_pred'):
        diffs[key] = check_close(f's2d {key} on the direct proposals',
                                 out_s[key], out_d[key])
    (rois_d, _, mask_d), (rois_s, _, mask_s) = rec_d[0][1], rec_s[0][1]
    moved = ((mask_d != mask_s)
             | ((rois_d - rois_s).abs() > ROI_ATOL).any(-1)).sum().item()
    (dd, vd), (ds, vs) = ([x.cpu().numpy() for x in d]
                          for d in (dets_d, dets_s))
    for i in range(len(dd)):
        match_detections(ds[i][vs[i]], dd[i][vd[i]], coord_atol=BOX_ATOL)
    print(f's2d against direct stem on float queries: max |diff| {diffs}; '
          f'detections on the direct proposals {vs.sum(1).tolist()} per '
          'image, equal (tie-aware); the s2d path\'s own proposals differ in '
          f'{moved} of {mask_d.numel()} slots', flush=True)
    return dict(diffs, own_proposals_moved=moved)


def conv1_times(seed, card):
    """Phase 16 (b): conv1 of one request (BATCH x QUERY_HW) as the direct
    7x7/2 conv over 3 channels, as `conv1_s2d`'s 4x4/1 conv over the 12
    packed channels, and over the packing zero-padded to 16 channels (a
    weight and an input of zeros, the same sums), in float32 (no TF32) and
    bf16, on channels_last tensors as the trunk runs them, by CUDA events
    beside each one's bound (the bytes at HBM_BYTES_PER_S, its products at
    the dtype's peak).  -> {dtype: {form: row}}."""
    import torch.nn.functional as F
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.models import layers as L
    from dana_tpu_torch.models import resnet
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    conv = from_jax_params(params, config).backbone.conv1.to(DEV)
    rng = np.random.default_rng(seed + 7)
    x = rng.normal(0, 50, (BATCH, *QUERY_HW, 3)).astype(np.float32)
    xs = {'direct': torch.as_tensor(x, device=DEV),
          's2d': torch.as_tensor(blob.s2d_pack(x), device=DEV)}
    xs['s2d16'] = F.pad(xs['s2d'], (0, 4))
    w16 = F.pad(resnet.stem_w4(conv.weight.detach()), (0, 0, 0, 0, 0, 4))
    taps = {'direct': 7 * 7 * 3, 's2d': 4 * 4 * 12, 's2d16': 4 * 4 * 16}
    out = {}
    with torch.inference_mode():
        for dname, dt, peak in (('float32', torch.float32, FP32_FLOP_PER_S),
                                ('bf16', torch.bfloat16, BF16_FLOP_PER_S)):
            v = {k: L.nhwc_to_nchw(t.to(dt)) for k, t in xs.items()}
            fns = {'direct': lambda: conv(v['direct']),
                   's2d': lambda: resnet.conv1_s2d(v['s2d'], conv),
                   's2d16': lambda: F.conv2d(v['s2d16'], w16.to(dt))}
            want = fns['direct']()
            errs = {k: (fns[k]() - want).float().abs().max().item()
                    for k in ('s2d', 's2d16')}
            if dt == torch.float32:
                check_close('conv1 s2d against direct', fns['s2d'](), want)
                check_close('conv1 s2d16 against direct', fns['s2d16'](),
                            want)
            rows = {}
            for k, fn in fns.items():
                n_out = want.numel()
                nbytes = (v[k].numel() + conv.weight.numel() * taps[k]
                          // taps['direct'] + n_out) * v[k].element_size()
                b_ms, b_by = bound_ms(nbytes, 2 * n_out * taps[k], peak)
                rows[k] = dict(ms=cuda_ms(fn, CONV1_ITERS), bound_ms=b_ms,
                               bound_by=b_by, macs=n_out * taps[k])
            out[dname] = dict(rows, max_abs_err=errs)
            print(f'conv1 {dname} ({card}), {list(want.shape)}: ' + ', '.join(
                f'{k} {r["ms"]:.4f} ms (bound {r["bound_ms"]:.4f}, '
                f'{r["bound_by"]}; {r["macs"] / 1e9:.2f} GMAC)'
                for k, r in rows.items())
                + f'; max |err| against direct {errs}', flush=True)
    return out


def request_times(seed, card, preds, rounds=3):
    """Phase 16 (b): requests of each predictor in `preds` ({(recipe,
    stem): pred}), each served once untimed, then in `rounds` rounds whose
    order alternates (direct then s2d, s2d then direct) -> {key: [ms]}."""
    reqs = serving_requests(seed, 1)
    packed = s2d_requests(reqs)
    for (_, stem), pred in preds.items():
        pred.predict(*(packed if stem == 's2d' else reqs)[0])
    times = {f'{r}_{s}': [] for r, s in preds}
    keys = list(preds)
    for i in range(rounds):
        for recipe, stem in (keys if i % 2 == 0 else keys[::-1]):
            req = (packed if stem == 's2d' else reqs)[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds[recipe, stem].predict(*req)
            torch.cuda.synchronize()
            times[f'{recipe}_{stem}'].append(
                (time.perf_counter() - t0) * 1e3)
    print(f'request ms by stem ({card}; {rounds} rounds, alternating): '
          f'{times}', flush=True)
    return times


def host_pack_times(seed):
    """Phase 16 (b): the host's work on a batch of BATCH images: the
    packing of uint8 canvases (native `pad_s2d` against its numpy plain
    version) and the mean subtraction of float32 600x800 images (native
    `meansub` against numpy), on one thread and on the dataset CLI's
    assembly threads (min(8, cores)), the median of HOST_ITERS passes;
    each native result equal to its plain version.  -> {op: {impl:
    {one_thread_ms, threads_ms}}}."""
    from concurrent.futures import ThreadPoolExecutor
    from dana_tpu_torch import native
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.utils import config as cfg
    rng = np.random.default_rng(seed + 8)
    pad = blob.u8_pad_of(cfg.PIXEL_MEANS)
    canvases = [rng.integers(0, 256, (*QUERY_HW, 3), dtype=np.uint8)
                for _ in range(BATCH)]
    images = [rng.integers(0, 256, (600, 800, 3)).astype(np.float32)
              for _ in range(BATCH)]
    ops = {
        'pad_s2d': (canvases, {
            'native': lambda c: native.pad_s2d(c, QUERY_HW, pad),
            'plain': lambda c: native.pad_s2d_plain(c, QUERY_HW, pad)}),
        'meansub': (images, {
            'native': lambda im: native.meansub(im, cfg.PIXEL_MEANS),
            'plain': lambda im: native.meansub_plain(im, cfg.PIXEL_MEANS)})}
    workers = min(8, os.cpu_count() or 1)
    out = {}
    with ThreadPoolExecutor(workers) as ex:
        for op, (ims, impls) in ops.items():
            if not all(np.array_equal(impls['native'](im),
                                      impls['plain'](im)) for im in ims):
                fail(f'native {op} differs from its plain version')
            out[op] = {}
            for impl, fn in impls.items():
                one, many = [], []
                for _ in range(HOST_ITERS):
                    t0 = time.perf_counter()
                    for im in ims:
                        fn(im)
                    one.append((time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    list(ex.map(fn, ims))
                    many.append((time.perf_counter() - t0) * 1e3)
                out[op][impl] = dict(one_thread_ms=float(np.median(one)),
                                     threads_ms=float(np.median(many)))
    print(f'host work on a batch of {BATCH} ({os.cpu_count()} cores, '
          f'{workers} threads): {out}', flush=True)
    return dict(out, cores=os.cpu_count(), threads=workers)


def pack_episode(batch):
    """A training episode (phase 5's, on the card) with its uint8 queries
    and float supports packed for the space-to-depth stem on the host, as
    the training CLI's loader packs them."""
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.utils import config as cfg
    pad = blob.u8_pad_of(cfg.PIXEL_MEANS)
    im = blob.s2d_pack(batch['im_data'].cpu().numpy(), u8_pad=pad)
    sup = blob.s2d_pack_any(batch['support_ims'].cpu().numpy())
    return dict(batch, im_data=torch.as_tensor(im, device=DEV),
                support_ims=torch.as_tensor(sup, device=DEV))


def s2d_export(seed, card, pred_s, requests):
    """Phase 16 (e): pred_s's detector exported for the space-to-depth
    stem at QUERY_HW and the support encoder (serve.py, s2d=True), loaded
    in this process and served: the encoder on six packed supports and
    one request of float packed queries, each bit for bit against the
    live port on the same inputs, the request's launches counted (K1 2,
    K2 1, NMS 2).  -> (launches, summary)."""
    from dana_tpu_torch import serve
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.utils import config as cfg
    config, model = pred_s.config, pred_s.model
    means = np.asarray(cfg.PIXEL_MEANS, np.float32)
    rng = np.random.default_rng(seed + 9)
    sup6 = torch.as_tensor(blob.s2d_pack_any(rng.integers(
        0, 256, (1, 6, SUPPORT_HW, SUPPORT_HW, 3)).astype(np.float32)
        - means), device=DEV)
    query, info, classes = requests[0]
    q = torch.as_tensor(query.astype(np.float32) - np.tile(means, 4),
                        device=DEV)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        meta = serve.export_predictor(model, config, out_dir,
                                      buckets=(QUERY_HW,), batch_size=BATCH,
                                      sup_size=SUPPORT_HW, s2d=True,
                                      device=DEV)
        export_s = time.perf_counter() - t0
        art = serve.load(out_dir)
        params = model.state_dict()
        with torch.inference_mode():
            enc_live = dana.extract_support_feats(model, config, sup6)
        enc = art.encode(params, sup6)
        # each query's row: its class's shots, then the other class's (the
        # artifact takes n_way * n_shot rows; the first n_shot are used)
        cf = {c: pred_s.batch_support_feats([c]) for c in (0, 1)}
        feats = tuple(torch.cat([torch.cat([cf[c][j], cf[1 - c][j]], 1)
                                 for c in classes]) for j in range(2))
        want = pred_s.predict(q, info, classes)
        art(params, q, info, *feats)              # untimed first call
        torch.cuda.synchronize()
        zero_launches()
        got = art(params, q, info, *feats)
        torch.cuda.synchronize()
        launches, syncs = read_launches(), nms_syncs()
    if not meta['s2d'] or tuple(meta['buckets'][0]['bucket']) != QUERY_HW:
        fail(f's2d export: meta {meta}')
    if launches != want_launches(config, 1, training=False) or syncs:
        fail(f's2d export: launches {launches}, NMS host syncs {syncs}')
    same_enc = all(torch.equal(a, b) for a, b in zip(enc, enc_live))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f's2d export ({card}): {QUERY_HW} bucket and the encoder in '
          f'{export_s:.1f} s; encoder bit for bit {same_enc}, request bit '
          f'for bit {same}; launches {launches}', flush=True)
    if not (same_enc and same):
        fail('the s2d artifact does not serve bit for bit what the live '
             'port serves')
    return launches, dict(export_s=export_s, bit_for_bit=same)


def s2d_path(seed, card, f32_training, cli, checkpath):
    """Phase 16: the space-to-depth stem (TPU.STEM_S2D).  (a) phase 4's
    detector with its supports packed serves REQUESTS packed requests as
    phase 4 does (counters zeroed around them; request 0 against the plain
    versions), then the float s2d request against the direct one
    (`s2d_against_direct`); (b) conv1, request and host times
    (`conv1_times`, `request_times` in float32 and the default recipe,
    `host_pack_times`); (c) phase 5's steps on packed episodes; (d) int8
    'all' on packed queries (53 `_int_mm` a request, conv1's included);
    (e) the s2d export (`s2d_export`); (f) the dataset CLI with --set
    TPU.STEM_S2D True on phase 7's checkpoint, its img/s, assembly
    thread-seconds and stats beside phase 6's.  -> ({path: launches},
    summary)."""
    from dana_tpu_torch import quant
    from dana_tpu_torch.models import layers as L
    from dana_tpu_torch.utils import config as cfg
    t0 = time.perf_counter()
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    requests = s2d_requests(serving_requests(seed, REQUESTS))
    if requests[0][0].shape != (BATCH, QUERY_HW[0] // 2 + 3,
                                QUERY_HW[1] // 2 + 3, 12):
        fail(f's2d queries of shape {requests[0][0].shape}')
    by_path, summary = {}, {}
    pred_s = serving_predictor(seed, (config, params), s2d=True)
    by_path['s2d_serving'], summary['serving'] = serving_path(
        seed, label='s2d path', pred=pred_s, requests=requests)
    pred_d = serving_predictor(seed, (config, params))
    summary['against_direct'] = s2d_against_direct(seed, pred_d, pred_s)
    torch.cuda.empty_cache()

    summary['conv1'] = conv1_times(seed, card)
    conf_r = _recipe(config, 'default_recipe')
    preds = {('float32', 'direct'): pred_d, ('float32', 's2d'): pred_s,
             ('default_recipe', 'direct'): serving_predictor(
                 seed, (conf_r, params)),
             ('default_recipe', 's2d'): serving_predictor(
                 seed, (conf_r, params), s2d=True)}
    summary['request_ms'] = request_times(seed, card, preds)
    del preds
    summary['host'] = host_pack_times(seed)
    torch.cuda.empty_cache()

    by_path['s2d_training'], summary['training'] = training_path(
        seed, label='s2d training', pack=pack_episode)
    print(f's2d training ({card}): steady step '
          f'{summary["training"]["steady_step_ms"]:.2f} ms; direct (phase 5) '
          f'{f32_training["steady_step_ms"]:.2f}', flush=True)
    torch.cuda.empty_cache()

    conf_q = dataclasses.replace(config, roi_align_int8=True)
    pred_q = serving_predictor(seed, (conf_q, quant.quantize_params(
        params, 'all')), s2d=True)
    if not isinstance(pred_q.model.backbone.conv1, L.QuantConv2d) \
            or quant.count_int8(pred_q.model) != INT8_CONVS['all'][0]:
        fail('int8 all: conv1 is not quantized')
    by_path['s2d_int8_all'], summary['int8_all'] = serving_path(
        seed, label='s2d int8 all', pred=pred_q, requests=requests)
    del pred_q
    torch.cuda.empty_cache()

    by_path['s2d_export'], summary['export'] = s2d_export(
        seed, card, pred_s, requests)
    del pred_s, pred_d
    torch.cuda.empty_cache()

    by_path['s2d_cli'], summary['cli'] = cli_path(
        seed, checkpath, S2D_SET, label='s2d CLI path')
    c = summary['cli']
    print(f'dataset CLI over synth_test with TPU.STEM_S2D ({card}): '
          f'{c["img_per_s"]:.2f} img/s, assembly {c["timing"]["assemble_s"]:.2f}'
          f' thread-s, AP {c["stats"][0]:.4f}; direct stem (phase 6): '
          f'{cli["img_per_s"]:.2f} img/s, assembly '
          f'{cli["timing"]["assemble_s"]:.2f} thread-s, AP '
          f'{cli["stats"][0]:.4f} (AP not judged)', flush=True)
    summary['phase_s'] = time.perf_counter() - t0
    return by_path, summary


@contextlib.contextmanager
def synth_root(tmp):
    """DANA_SYNTH_ROOT set to <tmp>/synth, restored after."""
    saved = os.environ.get('DANA_SYNTH_ROOT')
    os.environ['DANA_SYNTH_ROOT'] = os.path.join(tmp, 'synth')
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop('DANA_SYNTH_ROOT', None)
        else:
            os.environ['DANA_SYNTH_ROOT'] = saved


def main():
    if sys.argv[1:2] == ['--cli_rank']:
        return cli_rank_main(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ['--serve_child']:
        return serve_child_main(sys.argv[2])
    if sys.argv[1:2] == ['--export_child']:
        return export_child_main(sys.argv[2], sys.argv[3])
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--parallel_only', action='store_true',
                    help='phases 1, 2 and 13 alone (e.g. on several cards)')
    args = ap.parse_args()
    t_start = time.perf_counter()

    # phase 1: device
    if not torch.cuda.is_available():
        fail('no CUDA device: the port runs on the card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]                # name, limit
    print(card, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}, '
          f'count {torch.cuda.device_count()}', flush=True)
    from dana_tpu_torch.ops import build
    from dana_tpu_torch.utils.device import tf32_flags, use_full_f32
    use_full_f32()
    print(f'float32 math: {tf32_flags()}', flush=True)
    dev = torch.device('cuda', 0)

    # phase 2: build
    secs = build.build_all()
    print(f'{len(build.KERNELS)} kernel sources built in {secs:.1f} s',
          flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if 'ptxas info    : Used' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)

    if args.parallel_only:
        with tempfile.TemporaryDirectory() as tmp, synth_root(tmp):
            by_path, parallel = parallel_path(args.seed, card)
        print(json.dumps({'parallel_summary': parallel,
                          'launches_by_path': by_path}), flush=True)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}), flush=True)
        return
    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.inference_mode():
        k1_err, k1_sites = check_cisa(dev, gen)
        k2_err, k2 = check_roi_align(dev, gen)
        k3_err, k3 = check_roi_align_pw(dev, gen)
        k4_err, k4 = check_cisa_single(dev, gen)
        bucket_errs, buckets = check_buckets(dev, gen)
        # K2 and K3 on VGG16's 512-channel maps and on the --ls canvas
        # (K1's sites at both: check_cisa)
        widths = {'roi_align_fwd': {}, 'roi_align_pw': {}}
        k2_c512_err, widths['roi_align_fwd']['c512'] = check_roi_align(
            dev, gen, c=VGG_C, label='[c512]')
        k2_ls_err, widths['roi_align_fwd']['ls'] = check_roi_align(
            dev, gen, hw=LS_HW, r=LS_POST_NMS, label='[ls]')
        k3_c512_err, widths['roi_align_pw']['c512'] = check_roi_align_pw(
            dev, gen, c=VGG_C, label='[c512]')
        k3_ls_err, widths['roi_align_pw']['ls'] = check_roi_align_pw(
            dev, gen, hw=LS_HW, label='[ls]')
        # the bf16 kernels: K1 and K4, K2 at 1024 and 512 channels, at
        # every query bucket and on the --ls canvas
        k1b_errs, k1b_sites = check_cisa_bf16(dev, gen)
        k2b_err, k2b_sites = check_roi_align_bf16_all(dev, gen, card)
        combine_backward = check_combine_backward(dev, gen, card)
        bn_act_sites_ = check_bn_act(dev, gen)
    k1_err = max(k1_err, bucket_errs['cisa_shots'])
    k2_err = max(k2_err, bucket_errs['roi_align_fwd'], k2_c512_err,
                 k2_ls_err)
    k3_err = max(k3_err, k3_c512_err, k3_ls_err)
    backward = check_backward(dev, gen)
    torch.cuda.empty_cache()

    # phase 4: the serving path
    f32_dets, serve_nms, train_nms = {}, [], []
    serving_launches, serving = serving_path(args.seed, keep=f32_dets,
                                             nms_record=serve_nms)
    torch.cuda.empty_cache()
    # phase 5: the training path
    training_launches, training = training_path(args.seed,
                                                nms_record=train_nms)
    torch.cuda.empty_cache()
    # phase 3's NMS kernel, at the sites phases 4 and 5 gave it
    with torch.inference_mode():
        nms_sites, nms_err = check_nms({'serving proposals': serve_nms[0],
                                        'postprocess': serve_nms[1],
                                        'training proposals': train_nms[0]})
    del serve_nms, train_nms
    torch.cuda.empty_cache()
    # phases 7, then 6 on its checkpoint: the training CLI and the dataset
    # CLI, on synth sets written into a temporary DANA_SYNTH_ROOT
    with tempfile.TemporaryDirectory() as tmp, synth_root(tmp):
        train_cli_launches, train_cli, ckpt = train_cli_path(
            args.seed, training['steady_step_ms'])
        torch.cuda.empty_cache()
        cli_launches, cli = cli_path(args.seed, ckpt)
        torch.cuda.empty_cache()
        # phase 8: the other frameworks, then the meta CLIs
        fw_launches, frameworks = frameworks_path(args.seed, card)
        meta_launches, meta_cli = meta_cli_path(args.seed, card)
        torch.cuda.empty_cache()
        # phase 9: the other trunks and pooling modes, then their CLIs
        slice9_launches, slice9 = slice9_path(args.seed, card)
        slice9_cli_launches, slice9_cli = slice9_cli_path(args.seed, card)
        torch.cuda.empty_cache()
        # phase 10: the precision recipe, then the dataset CLI in the
        # default recipe on phase 7's checkpoint
        t10 = time.perf_counter()
        precision_launches, precision = precision_path(args.seed, card,
                                                       serving)
        recipe_cli_launches, recipe_cli = cli_path(
            args.seed, ckpt, RECIPE_SET, label='recipe CLI path')
        print(f'dataset CLI over synth_test in the default recipe: AP '
              f'{recipe_cli["stats"][0]:.4f}, {recipe_cli["img_per_s"]:.2f} '
              f'img/s; float32 (phase 6): AP {cli["stats"][0]:.4f}, '
              f'{cli["img_per_s"]:.2f} img/s (AP not judged)', flush=True)
        precision['phase_s'] = time.perf_counter() - t10
        print(f'phase 10 took {precision["phase_s"]:.1f} s; the run '
              f'{time.perf_counter() - t_start:.1f} s so far', flush=True)
        # phase 11: the recipe in training, then its CLIs
        t11 = time.perf_counter()
        bf16_train_launches, bf16_train = bf16_training_path(
            args.seed, card, training)
        recipe_train_cli_launches, recipe_train_cli = recipe_cli_path(
            args.seed, card, cli)
        bf16_train['phase_s'] = time.perf_counter() - t11
        print(f'phase 11 took {bf16_train["phase_s"]:.1f} s; the run '
              f'{time.perf_counter() - t_start:.1f} s so far', flush=True)
        # phase 12: the N-way evaluation, VOC through both CLIs, product
        # attention and remat_backbone
        t12 = time.perf_counter()
        slice14_launches, slice14 = {}, {}
        for part, path in (
                ('multiway', lambda: multiway_path(args.seed, card, ckpt)),
                ('voc', lambda: voc_cli_path(args.seed, card)),
                ('product', lambda: product_path(args.seed, card)),
                ('remat', lambda: remat_path(args.seed, card))):
            part_launches, slice14[part] = path()
            slice14_launches.update(part_launches)
            torch.cuda.empty_cache()
        slice14['phase_s'] = time.perf_counter() - t12
        print(f'phase 12 took {slice14["phase_s"]:.1f} s; the run '
              f'{time.perf_counter() - t_start:.1f} s so far', flush=True)
        # phase 13: data, tensor and spatial parallelism, multi-process
        # training and evaluation
        parallel_launches, parallel = parallel_path(args.seed, card)
        print(f'phase 13 took {parallel["phase_s"]:.1f} s; the run '
              f'{time.perf_counter() - t_start:.1f} s so far', flush=True)
        # phase 14: int8 serving, then the dataset CLI with QUANT_INT8
        int8_launches, int8 = int8_path(
            args.seed, card, serving, f32_dets['dets'],
            precision['default_recipe'], cli, ckpt)
        print(f'phase 14 took {int8["phase_s"]:.1f} s; the run '
              f'{time.perf_counter() - t_start:.1f} s so far', flush=True)
        # phase 16: the space-to-depth stem (its CLI part serves phase 7's
        # checkpoint, so it runs here, before phase 15)
        s2d_launches, s2d = s2d_path(args.seed, card, training, cli, ckpt)
        print(f'phase 16 took {s2d["phase_s"]:.1f} s; the run '
              f'{time.perf_counter() - t_start:.1f} s so far', flush=True)
    # phase 15: serving export
    export_launches, export = serving_export_path(args.seed, card, serving)
    print(f'phase 15 took {export["phase_s"]:.1f} s; the run '
          f'{time.perf_counter() - t_start:.1f} s so far', flush=True)

    by_path = {'serving': serving_launches, 'training': training_launches,
               'cli': cli_launches, 'train_cli': train_cli_launches,
               **fw_launches, **meta_launches, **slice9_launches,
               **slice9_cli_launches, **precision_launches,
               'recipe_cli': recipe_cli_launches, **bf16_train_launches,
               **recipe_train_cli_launches, **slice14_launches,
               **parallel_launches, **int8_launches, **export_launches,
               **s2d_launches}
    launches = {name: sum(p.get(name, 0) for p in by_path.values())
                for name in launch_counters()}
    print(json.dumps({'serving_summary': serving,
                      'training_summary': training,
                      'cli_summary': cli,
                      'train_cli_summary': train_cli,
                      'frameworks_summary': frameworks,
                      'meta_cli_summary': meta_cli,
                      'slice9_summary': slice9,
                      'slice9_cli_summary': slice9_cli,
                      'precision_summary': precision,
                      'recipe_cli_summary': recipe_cli,
                      'bf16_training_summary': bf16_train,
                      'recipe_train_cli_summary': recipe_train_cli,
                      'slice14_summary': slice14,
                      'parallel_summary': parallel,
                      'int8_summary': int8,
                      'export_summary': export,
                      's2d_summary': s2d,
                      'launches_by_path': by_path,
                      'backward': backward,
                      'combine_backward': combine_backward,
                      'kernel_sites': {'cisa_shots': k1_sites,
                                       'roi_align_fwd': {'roi': k2},
                                       'roi_align_pw': {'train_roi': k3},
                                       'cisa_attention': {'main': k4},
                                       'buckets': buckets,
                                       'widths': widths,
                                       'nms': nms_sites,
                                       'bn_act': bn_act_sites_,
                                       'bf16': {'cisa': k1b_sites,
                                                'roi_align_fwd':
                                                    k2b_sites}}}),
          flush=True)

    def row(name, source, replaces, err, sites):
        vals = list(sites.values())
        lib = [v['library_ms'] for v in vals]
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': launches[name],
                'max_abs_err': err,
                'ms': sum(v['ms'] for v in vals),
                'plain_ms': sum(v['plain_ms'] for v in vals),
                'bound_ms': sum(v['bound_ms'] for v in vals),
                'bound_by': vals[0]['bound_by'],
                'library_ms': None if None in lib else sum(lib)}

    serving_k1 = {k: k1_sites[k] for k in ('rpn', 'roi')}
    kernels = [
        row('cisa_shots', 'dana_tpu_torch/ops/csrc/cisa_shots.cu',
            'dana_tpu/ops/cisa_attention.py:173', k1_err, serving_k1),
        row('roi_align_fwd', 'dana_tpu_torch/ops/csrc/roi_align.cu',
            'dana_tpu/ops/roi_align_pallas.py:221', k2_err, {'roi': k2}),
        row('roi_align_pw', 'dana_tpu_torch/ops/csrc/roi_align.cu',
            'dana_tpu/ops/roi_align_pallas.py:175', k3_err,
            {'train_roi': k3}),
        row('cisa_attention', 'dana_tpu_torch/ops/csrc/cisa_shots.cu',
            'dana_tpu/ops/cisa_attention.py:65', k4_err, {'main': k4}),
        row('cisa_shots_bf16', 'dana_tpu_torch/ops/csrc/cisa_shots_bf16.cu',
            'dana_tpu/ops/cisa_attention.py:173', k1b_errs['shots'],
            {k: k1b_sites[k] for k in ('rpn', 'roi')}),
        row('roi_align_fwd_bf16', 'dana_tpu_torch/ops/csrc/roi_align.cu',
            'dana_tpu/ops/roi_align_pallas.py:221', k2b_err,
            {'roi': k2b_sites['roi']}),
        row('cisa_attention_bf16',
            'dana_tpu_torch/ops/csrc/cisa_shots_bf16.cu',
            'dana_tpu/ops/cisa_attention.py:65', k1b_errs['single'],
            {'main': k1b_sites['single']}),
        # replaces no Pallas kernel: the XLA NMS of nms_fixed_tiled
        row('nms', 'dana_tpu_torch/ops/csrc/nms.cu',
            'dana_tpu/ops/nms.py:116', nms_err,
            nms_sites),
    ]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
