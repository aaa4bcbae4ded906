"""Drive the PyTorch port's paths on one NVIDIA GPU and check them: COMBO-R50
S4 inference, S4 training, and the S4 evaluation and training entry points,
the model variants without one of COMBO's components and with the other
pixel decoders, the offline data tools,
the evaluation with test-time augmentation and prediction dumps, data
parallelism (ranks over gloo on the card, `train_net --num-devices` over
NCCL); the JPEG
codec; COMBO-R50 on AVSS (JPEG frames) (71 classes): the bf16 AMP training step and the AVSS
training and evaluation entry points; then COMBO-PVTv2-B5 at full depth and
width through the S4 steps, its training entry point, and the MS3
evaluation entry point.

    python3 chip_smoke.py [--kernels-only]

Phases, each printing what it found; any failure raises, so the script exits
non-zero and never prints its last line:
  1. environment: torch/CUDA versions, the card, `nvidia-smi` name and power limit;
  2. build every kernel from `combo_avs_torch/csrc` (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     the two paths give it and at a ragged shape (K3/K5 also at its launch
     plan's edges), with three times for the kernel and for one PyTorch call
     computing the same function where there is one: device ms (calls
     captured back to back in a CUDA graph and replayed, so no host time
     enters), call ms (one eager call between events, the wrapper's host
     time included, as the eager main path pays it) and host us per call;
     the plain version's call ms; and the least time the card could take
     (bound):
       K1 deformable-attention forward under both launch plans (staged, the
       plan's choice, and global; fp32 and bf16 value; eval and training shapes;
       at TTA's 384^2 shapes the grouped plan, a smaller block on the whole
       slice or on a channel group of it, against global),
       K2 its backward under both launch plans (level_slice, the plan's
       choice, and global; also a level one row over the opt-in limit), and
       in bf16 (the AMP step's types) at the AVSS training shape and a
       ragged one, against the plain version's fp32 autograd on the same
       bf16-rounded inputs,
       K3/K5 the point-sample forward, K4 its backward (the image gradient
       under both launch plans, staged, the plan's choice, and global, at
       the plan's edges),
       K7 the fused semantic inference under both launch plans (patch at
       integer ratios, the plan's choice, and pixel; fp32 and bf16 masks;
       also the time of F.interpolate alone), K6 the point gather (against
       torch.gather, int64 and int32 indices; at the criterion's shape also
       its floors: an empty kernel on its grid, a streaming copy of its index
       into its output, the gather warm and with its source flushed from
       L2); K1 and K7 also at the TTA branches' shapes (128^2 and 384^2
       frames: K1's grouped plan against global at 384^2 in bf16 and fp32,
       and K7's pixel plan at 384^2, timed); the matcher's fused cost kernel
       (`csrc/match_cost.cu`) against its composition (`cost_matrix`, then
       nan_to_num) at the training cells' shape and at AVSS's 12 slots and 72
       classes, with its bound (bytes, fp32 operations or MUFU results) and
       the composition's device and call ms;
     then each kernel ranked against its library call by device ms;
  3b. jpeg: the host JPEG codec built from `combo_avs_torch/native/jpeg.c`;
     synthetic frames at 224^2 and 1280 x 720 encoded at quality 95 and
     decoded at 4:2:0, 4:4:4 and gray, each round trip above its PSNR
     floor, ms per frame of each;
  4. full-width COMBO-R50 S4 (`MaskFormer()` defaults) from a seeded init on
     the card, `make_eval_step` on 3 batches of 4 videos x 5 frames x 224^2 in
     fp32 and in bf16; K1 must be launched 6 times and K7 once per batch
     (through its patch plan);
  5. the eval entry point: a synthetic S4 val tree of 16 videos x 5 frames x
     224^2 (`data/synth.py`), the model saved as a reference `.pth` and
     loaded back, `train/evaluate.py::evaluate` at batch 4 in fp32 and bf16
     (K7 once per batch), once more in fp32 with the plain semantic
     inference on the card, whose metrics must agree, and once with the
     metrics on 2 forked worker processes (`COMBO_EVAL_PROCS=2`), whose
     metrics must be equal;
  5b. tta: `pred --config-file avs_s4/Test_COMBO_R50_bs8_90k.yaml --save-vis
     TEST.AUG.ENABLED True` over a synthetic S4 test split of 8 videos at
     batch 4, bf16: metrics in [0, 1], K1 and K7 launches by plan each batch
     as the plan functions give them at 128^2, 224^2 and 384^2 with flip,
     one vis PNG per frame equal to the argmax of its prediction; then on
     one batch TTA at [224] without flip against make_eval_step (bit for
     bit), bf16 TTA against fp32 (held to 1.5 x the plain step's bf16
     error), and the bf16 TTA step's wall and device time;
  6. `make_train_step` on the same model, 1 warm-up and 3 timed steps of
     8 videos x 5 frames x 224^2, K = 3 target slots, fp32, S4 frame weights:
     finite losses, the frozen tower and FrozenBN unchanged, the decoder
     changed, and each kernel launched as often as the step implies (K4's
     image gradient through its staged plan);
  7. the training entry point: `python -m combo_avs_torch.train_net` (its
     `main`, in this process) on the shipped
     `combo_avs_tpu/configs/avs_s4/COMBO_R50_bs8_90k.yaml` at full width and
     with the full augmentation, over a synthetic S4 tree (16 train videos,
     8 val), 2 iterations with an evaluation and a step checkpoint at 2,
     then resumed to 3: every iteration logged (the resumed run 3 only),
     finite losses, step_2, step_3 and a `model_best.pth` that loads,
     the mIoU in metrics.json, and each kernel launched as often as the
     steps and the evaluation batches imply, through the training phase's
     plans; its s/iter and data_time per iteration beside the bare step's,
     and the evaluation's videos/s;
  8. the same weights on the card (TF32 off) against the CPU (plain path):
     the inference forward on one 224^2 frame, and the training losses and
     gradients on 1 video x 5 frames x 128^2 with the same injected draws;
     the card takes the CPU's matching and the CPU's decoder attention masks,
     each held to the bound a near-tie allows;
  9. one training step at 12500 points, whose 37500 candidates the
     stratified selection does not divide, so that K6 runs once per decoder
     output;
  9b. ddp, data parallelism on COMBO-R50 S4 at full width: (a) 2 ranks,
     spawned processes sharing card 0 over gloo, run 3 steps of phase 6's
     global batch (4 videos a rank, fp32, TF32 and dropout off) against one
     process on the whole batch, each step of which starts from the ranks'
     weights: every step's losses within 1e-3 relative, its gradient per
     leaf within 0.15 rel-L2 and its global norm within 1e-2, the weights it
     updates within 1e-3 of the largest weight; then 3 more steps timed
     (each rank's s/step, gradient all-reduce ms, peak memory and kernel
     launches by plan printed); (c) the 2 ranks evaluate 4 synthetic
     val videos, whose merged metrics must equal one process's within 1e-6;
     (b) `python -m combo_avs_torch.train_net --num-devices <cards> --max-iter
     2` on the shipped R50 S4 config over NCCL (one rank on a one-card host):
     one metrics.jsonl, an evaluation and a checkpoint, whose merged metrics
     equal a one-process `Trainer.test` of that checkpoint exactly;
  9c. variants: six models `build_model` builds from the shipped R50 S4
     config with overrides, each one code path the flagship does not take
     (VARIANTS: (a) no pre-SAM tower + MHA-S fusion, (b) MHA-S-Audio + the
     "dim" query fusion + no cosine loss, (c) MHA-None + the "all" query
     fusion + the decoder's input projections, (d) early fusion on res2 + a
     trained VGGish tower + SGD, (e) the BasePixelDecoder, (f) the
     TransformerEncoderPixelDecoder), full width, seeded weights: one bf16
     eval step of 4 videos x 5 frames x 224^2 and one fp32 train step of 8,
     each after a warm-up, with their walls, the train step's peak memory,
     finite losses and every kernel's launches by plan (the FPN decoders
     launch no K1 or K2); phase 8's card-vs-CPU forward on (a), (d) and (e);
  9d. variant-entry: `train_net` on the shipped R50 S4 config with model
     (a) and SGD as trailing overrides, 2 iterations with an evaluation and a
     checkpoint (no Maskiges in its batches), then `pred` on its
     model_best.pth, the launches of both counted;
  9e. tools: `python -m combo_avs_torch.tools.preprocess_audio` on the card
     (a synthetic 10 s 44.1 kHz stereo wav, held to the CPU frontend within
     1e-4), `maskige` and `resize_frames` on a synthetic tree, their outputs
     read back by the port's readers;
  10. COMBO-R50 AVSS: `build_model` of the shipped avs_ss/COMBO_R50_bs8_90k.yaml
     (71 classes, SOLVER.AMP.ENABLED) with seeded weights: 4 bf16 AMP steps,
     the first a warm-up, of 8 videos x 10 frames x 224^2, K = 12 slots, v2
     flags (avss-train: s/step, peak memory, and one more step with the
     matcher's wall and its solve's; each kernel's
     launches per step by plan, K2 all bf16); the AMP forward's losses
     against the fp32 one's on the same weights, batch, draws and matching
     (avss-amp-vs-fp32); `train_net` on that config over a synthetic AVSS
     tree (3 train, 3 val, 5 test videos; v1s, v1m, v2; JPEG frames, as
     AVSBench-semantic's), 2 iterations with
     an evaluation and a checkpoint (avss-entry); then `pred --config-file
     avs_ss/Test_COMBO_R50_bs8_90k.yaml` with its model_best.pth and no
     `--dataset` or `--bf16` over the 5 test videos, which must score
     avss_sem_seg_test in bf16 (avss-pred: its four metrics and timers, K1
     6 and K7 0 a batch);
  11. COMBO-PVTv2-B5: `build_model` of the shipped
     `avs_s4/COMBO_PVTV2B5_bs8_90k.yaml` on the card (B5 towers at depths 3,
     6, 40, 3), seeded weights; phases 4, 6 and 8 on it (pvt-slice and
     pvt-train, each with a profiler window: device kernel ms a step and
     its share of the step's wall; pvt-train's peak memory;
     pvt-card-vs-cpu with the eval forward on 1 video x 5 frames x 224^2),
     the same launch checks; phase 7 on that config without the resumed
     run (pvt-entry); then `python -m combo_avs_torch.pred --config-file
     avs_ms3/Test_COMBO_PVTV2B5_bs8_20k.yaml` with the model_best.pth it wrote
     and no `--dataset`, over a synthetic MS3 test tree of 16 videos
     (pred-ms3: the config's avsms3_sem_seg_test in bf16, mIoU, F-score,
     videos/s, its timers, K1 six and K7 one launch per batch); no entry
     point may import jax, flax, yaml, cv2, tensorflow or the JAX package;
  12. the wall of each phase and the total, a JSON line of per-kernel
     results (`ms` device ms, `call_ms` call ms; launches by path, the ddp
     paths per rank), then the final JSON status line.
Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# main-path shapes: the eval batch of bench.py's default mode
B, T, SIZE = 4, 5, 224
NUM_BATCHES = 3
SEED = 0
K1_LEVELS = ((7, 7), (14, 14), (28, 28))  # res5, res4, res3 at 224^2
K1_SHAPE = dict(B=B * T, M=8, D=32, P=4)
# fp32: both sides sum the same fp32 products in another order
K1_TOL_FP32 = 1e-5  # max |kernel - plain| / max |plain|
# bf16: both sides accumulate fp32 and round the output to bf16 once, so a
# different summation order can move an element by one bf16 ulp (2^-8 relative)
K1_TOL_BF16 = 8e-3  # max |kernel - plain| / max |plain|
# card vs CPU, fp32 with TF32 off: another summation order through two R50
# towers, 6 encoder and 9 decoder layers (tests/test_e2e_parity.py's bound)
SLICE_ATOL, SLICE_RTOL = 5e-3, 1e-3

# training shapes: the S4 recipe's batch (IMS_PER_BATCH 8) of 5-frame videos,
# K = 3 target slots (the first two valid, as bench.py's bench_train), 100
# queries, masks at 56^2, 12544 PointRend points from 3 x 12544 candidates
TRAIN_B, TRAIN_K = 8, 3
TRAIN_STEPS = 3  # timed, after one warm-up step
TRAIN_N = TRAIN_B * T  # frames
TRAIN_M = TRAIN_N * TRAIN_K  # matched masks
MASK_HW, GT_HW, NUM_POINTS, NUM_QUERIES = SIZE // 4, SIZE, 12544, 100
DEC_OUTPUTS = 10  # the final prediction and 9 aux ones
# kernel launches per training step: the 6 encoder layers once forward and
# once backward; per decoder output the matcher samples the target masks (K3)
# and computes its cost in one fused kernel (float32 masks, the AMP step's
# too: its outputs reach the criterion as float32), the criterion samples the
# 3x oversampled candidates, the point labels and the point logits (4
# point-sample forward calls, K5 none), and the backward takes the point
# logits' image gradient once; no point ever needs a gradient
TRAIN_LAUNCHES = {"k1": 6, "k2": 6, "k3": 4 * DEC_OUTPUTS, "k4_dimg": DEC_OUTPUTS, "k4_dxy": 0,
                  "k6": 0, "k7": 0, "match_cost": DEC_OUTPUTS}
# the K6 step: 12500 points give 37500 candidates, not a multiple of the
# stratified chunk (256), so each decoder output takes top-k and K6
FALLBACK_POINTS = 12500
# K2, K4: fp32 atomics add in a run-dependent order, K3/K5 sum four products
# in another order than the plain version: 1e-5 of max |plain|
TOL_FP32 = 1e-5
# K2 in bf16: both sides read the same bf16 value, grad, locations and
# weights and sum in fp32 (in another order), and each gradient is rounded
# to bf16 once, so an element can differ by one bf16 ulp (2^-8 relative)
K2_TOL_BF16 = 8e-3  # max |kernel - plain| / max |plain|, K1's bf16 bound
# AVSS training: the recipe's 8 videos of the 10-frame bucket (v2), K = 12
# target slots, 71 classes, bf16 AMP (combo_avs_tpu/configs/avs_ss/
# R50-AVSS-SemanticSegmentation.yaml: IMS_PER_BATCH 8, SOLVER.AMP.ENABLED)
AVSS_B, AVSS_T, AVSS_K, AVSS_CLASSES = 8, 10, 12, 71
AVSS_N = AVSS_B * AVSS_T  # frames
AVSS_STEPS = 4  # AMP steps, the first a warm-up; then one more with the matcher timed
# the AMP forward's losses against the fp32 forward's on the same weights,
# batch and draws, the fp32 pass's matching, attention masks and uncertain
# points shared: the forward rounds every activation to bf16 (2^-9
# relative) through two R50 towers, 6 encoder and 9 decoder layers, and the
# losses are taken in fp32 on those outputs; the CPU test of the tiny model
# measured 3.3e-3 (tests/test_torch_avss_train.py)
AVSS_AMP_LOSS_RTOL = 5e-2  # |bf16 - fp32| / max(1, |fp32|), each loss
# the AVSS entry points: a synthetic tree of 3 train videos (a v1s, a v1m
# and a v2: batches of 8 from either frame bucket, videos repeated), 3 val
# videos (one a batch, as the trainer evaluates), 5 test videos (4 of 5
# frames and 1 of 10: a batch of each bucket at batch 4); 2 iterations with
# an evaluation and a checkpoint at 2. AVSBench-semantic's splits are far
# larger; these are cut for the call's time (the AVSS metrics take the host
# about 0.6 s a video)
AVSS_TRAIN_VIDEOS, AVSS_VAL_VIDEOS, AVSS_TEST_VIDEOS, AVSS_ENTRY_ITERS = 3, 3, 5, 2
# training, card vs CPU (1 video x 5 frames x 128^2, TF32 off, the same
# weights and draws, exact top-k on both): each loss within 1e-3 relative;
# gradients by the calibrated bounds of tests/test_grad_oracle.py for two
# implementations whose activations differ by float32 noise (per leaf rel-L2
# 0.15, median over leaves 0.03, whole gradient 0.075). A few leaves have an
# exactly zero gradient (a bias followed by a GroupNorm; the fusion's query
# bias under a softmax that one shift moves alike), where both sides hold
# rounding noise: a leaf's error is taken relative to at least 1e-6 of the
# whole gradient's norm
TRAIN_VS_CPU_SIZE = 128
LOSS_RTOL_CPU, GRAD_RL2_LEAF, GRAD_RL2_MEDIAN, GRAD_RL2_ALL = 1e-3, 0.15, 0.03, 0.075
GRAD_FLOOR = 1e-6

# the point-sample forward's launch-plan edges: name, feat [N, H, W, C],
# points, inputs misaligned
POINT_EDGE_CASES = (
    ("ragged", (3, 7, 5, 33), 101, False),
    ("c3_p_odd", (3, 56, 56, 3), 12545, False),
    ("c4_staged", (3, 32, 32, 4), 1003, False),
    ("c4_global", (2, 56, 56, 4), 1000, False),
    ("one_over_stage_limit", (2, 1, 12289, 1), 3001, False),
    ("many_images", (70000, 2, 2, 1), 6, False),
    ("misaligned_c1_staged", (4, 56, 56, 1), 2048, True),
    ("misaligned_c3_global", (2, 224, 224, 3), 999, True),
    ("misaligned_channels", (2, 56, 56, 100), 300, True),
)

# K4 dimg at the criterion's shape and its launch plan's edges: name, feat
# [N, H, W, C], points, inputs misaligned, the kernel the plan must choose on
# an H100's 132 SMs (global below 8 images; and images at and one element
# over the card's opt-in shared memory, made from the card's limit in
# phase_point_sample)
DIMG_CASES = [
    ("train", (TRAIN_M, MASK_HW, MASK_HW, 1), NUM_POINTS, False, "staged"),
    ("ragged", (3, 7, 5, 33), 101, False, "global"),
    ("c4_staged", (16, 32, 32, 4), 1003, False, "staged"),
    ("c3_odd_p", (16, 56, 56, 3), 12545, False, "staged"),
    ("misaligned", (16, 56, 56, 1), 2048, True, "staged"),
    ("eight_images", (8, 56, 56, 1), 12544, False, "staged"),
    ("one_image", (1, 56, 56, 1), 12544, False, "global"),
    ("many_images", (300, 56, 56, 1), 2000, False, "staged"),
]

# K7 at the eval tail: mask [20, 100, 56, 56] -> [20, 2, 224, 224]
K7_SHAPE = dict(N=B * T, Q=NUM_QUERIES, C=2, h=MASK_HW, w=MASK_HW)
# bf16: the plain version rounds the upsampled logits and their sigmoid to
# bf16 (each at most 2^-9 relative) before its fp32 contraction, the kernel
# interpolates and takes the sigmoid in fp32 from the same bf16 inputs; the
# sum over queries of those differences stays within 8e-3 of max |plain|
K7_TOL_BF16 = 8e-3
# K6 in the criterion's fallback: M = 120 masks of 3 x 12544 candidate
# points, 9408 uncertain points each
K6_SHAPE = dict(G=TRAIN_M, NS=3 * NUM_POINTS, P=3 * NUM_POINTS // 4)
# K6's cold floor: a read of this many bytes, twice the card's 50 MB L2,
# evicts the source before each gather
K6_FLUSH_BYTES = 96 << 20
# the eval entry point: a synthetic S4 val split, evaluated at batch 4
EVAL_VIDEOS, EVAL_BATCH = 16, 4
# the training entry points (COMBO-R50, then COMBO-PVTv2-B5): two distinct
# batches of 8 train videos, 8 val videos (one a batch, as the trainer
# evaluates), 2 iterations with an evaluation and a checkpoint at 2, then
# (R50 only) resumed to 3
ENTRY_TRAIN_VIDEOS, ENTRY_VAL_VIDEOS = 2 * TRAIN_B, 8
ENTRY_ITERS, ENTRY_PERIOD, ENTRY_RESUME_TO = 2, 2, 3
# the data-parallel phase (ddp), COMBO-R50 S4 at full width: (a) the train
# phase's global batch (IMS_PER_BATCH 8 x 5 frames x 224^2, K = 3, fp32, TF32
# off) over DDP_RANKS ranks that share card 0 through gloo (NCCL takes one
# rank a card), DDP_STEPS steps against the one-process steps on the whole
# batch, each of which starts from the weights the ranks' previous step
# left (rank 0 keeps them): AdamW moves a weight by about its rate whatever
# its gradient's size, so a gradient entry that rounding leaves near zero
# steps one way on the ranks and the other way in one process, and the runs
# would drift apart. Each step's losses at the train-card-vs-cpu bounds,
# its gradient per leaf too, its global norm within DDP_GRAD_NORM_RTOL, and
# the weights it updates within DDP_WEIGHT_RTOL of the largest weight (two
# opposite moves of the rate, 2e-4, fit); dropout off on both sides (each
# rank draws its own masks, which one process cannot reproduce). Then
# DDP_STEPS more steps are timed; (c) the ranks' evaluation of
# DDP_VAL_VIDEOS synthetic val videos (fp32, one a batch, seeded weights)
# against one process's, within DDP_METRIC_ATOL; (b) `train_net
# --num-devices <the host's cards>` over NCCL on DDP_TRAIN_VIDEOS train
# videos, 2 iterations with an evaluation and a checkpoint at 2, whose
# merged metrics must equal the one-process `Trainer.test` of its checkpoint
DDP_RANKS, DDP_STEPS = 2, 3
DDP_TRAIN_VIDEOS, DDP_VAL_VIDEOS, DDP_ENTRY_ITERS = TRAIN_B, 4, 2
DDP_GRAD_NORM_RTOL, DDP_WEIGHT_RTOL, DDP_METRIC_ATOL = 1e-2, 1e-3, 1e-6
# the MS3 evaluation entry point: a synthetic MS3 val split, at batch 4
PRED_VIDEOS = 16
CONFIG_DIR = os.path.join(REPO, "combo_avs_tpu", "configs")
R50_CONFIG = os.path.join(CONFIG_DIR, "avs_s4", "COMBO_R50_bs8_90k.yaml")
PVT_CONFIGS = {"s4": os.path.join(CONFIG_DIR, "avs_s4", "COMBO_PVTV2B5_bs8_90k.yaml"),
               "ms3": os.path.join(CONFIG_DIR, "avs_ms3", "COMBO_PVTV2B5_bs8_20k.yaml")}
MS3_TEST_CONFIG = os.path.join(CONFIG_DIR, "avs_ms3", "Test_COMBO_PVTV2B5_bs8_20k.yaml")
AVSS_CONFIG = os.path.join(CONFIG_DIR, "avs_ss", "COMBO_R50_bs8_90k.yaml")
AVSS_TEST_CONFIG = os.path.join(CONFIG_DIR, "avs_ss", "Test_COMBO_R50_bs8_90k.yaml")
# K7 against the plain tail on the same forward (fp32): the maps differ by
# fp32 rounding (1e-5 of max |plain|), which can flip a pixel lying within
# that of the 0.5 threshold; the metrics, rounded to 4 decimals, may move by
# a few units of the last place
EVAL_METRIC_ATOL = 1e-3

# test-time augmentation through `pred --save-vis TEST.AUG.ENABLED True`: a
# synthetic S4 test split at batch EVAL_BATCH, bf16 (TEST.BF16 auto), every
# shipped config's TEST.AUG.MIN_SIZES (the default) with flip
TTA_VIDEOS = 8
TTA_CONFIG = os.path.join(CONFIG_DIR, "avs_s4", "Test_COMBO_R50_bs8_90k.yaml")
TTA_SCALES = (128, 224, 384)
# bf16 TTA against fp32 TTA on one batch: the full-width maps on random
# weights sum 100 queries (their largest value about 20-50), and bf16 moves
# them by 4-6% of that in the plain eval step and in each TTA branch alike
# (measured on the card: plain 6.1e-2, 128^2 4.6e-2, 384^2 5.2e-2, TTA
# 3.9e-2; sharing the decoder's attention masks changes none of it), so
# TTA's max |bf16 - fp32| over max |fp32| is held to this multiple of the
# plain eval step's on the same batch (tests/test_bf16_eval.py's 0.05
# absolute is the tiny model's, whose maps sum 8 queries)
BF16_TTA_MARGIN = 1.5
# the JPEG codec's round trip at quality 95 on synthetic frames (smooth
# background, a shape, fine noise in every channel, which 4:2:0 halves in
# chroma): PSNR floors in dB, a few below what the CPU measures (32.4 / 36.7
# / 43.1 at 224^2)
JPEG_QUALITY = 95
JPEG_PSNR_FLOOR = {"420": 30.0, "444": 34.0, "gray": 40.0}
JPEG_SIZES = ((SIZE, SIZE), (720, 1280))  # a frame, and an AVSBench source frame

# the model variants (variants phase): full COMBO-R50 width, the shipped S4
# config with these overrides, seeded weights; each one code path the
# flagship does not take. A bf16 eval step at B x T x 224^2 and an fp32 train
# step at TRAIN_B x T x 224^2, K = TRAIN_K, each after a warm-up step
VARIANTS = {
    "a_nosem_mha_s": ["MODEL.PRE_SAM.USE_PRE_SAM", "False", "MODEL.FUSE_CONFIG.TYPE", "MHA-S"],
    "b_s_audio_dim_nocos": ["MODEL.FUSE_CONFIG.TYPE", "MHA-S-Audio",
                            "MODEL.FUSE_CONFIG.QUERIES_FUSE_TYPE", "dim",
                            "MODEL.MASK_FORMER.COSINE_WEIGHT", "0.0"],
    "c_none_all_proj": ["MODEL.FUSE_CONFIG.TYPE", "MHA-None",
                        "MODEL.FUSE_CONFIG.QUERIES_FUSE_TYPE", "all",
                        "MODEL.MASK_FORMER.ENFORCE_INPUT_PROJ", "True"],
    "d_early_vggish_sgd": ["MODEL.FUSE_CONFIG.FUSION_STEP", "early",
                           "MODEL.AUDIO.FREEZE_AUDIO_EXTRACTOR", "False",
                           "SOLVER.OPTIMIZER", "SGD"],
    "e_base_fpn": ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME", "BasePixelDecoder"],
    "f_transformer_fpn": ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME",
                          "TransformerEncoderPixelDecoder"],
}
# the variants the card-vs-CPU forward also runs on (phase 8's bounds)
VARIANTS_VS_CPU = ("a_nosem_mha_s", "d_early_vggish_sgd", "e_base_fpn")
# the variant entry point: `train_net` on the shipped S4 config with model
# (a) and SGD over ENTRY_TRAIN_VIDEOS / VARIANT_VAL_VIDEOS synthetic videos,
# 2 iterations with an evaluation and a checkpoint at 2; then `pred` on it
VARIANT_ENTRY_OPTS = VARIANTS["a_nosem_mha_s"] + ["SOLVER.OPTIMIZER", "SGD"]
VARIANT_VAL_VIDEOS = 4
# the tools phase: a 10 s 44.1 kHz stereo wav through `preprocess_audio` on
# the card, held to the CPU frontend (the log-mel's float32 FFTs on two
# devices; the CPU tests hold the CPU frontend to JAX's at the same bound)
TOOLS_LOG_MEL_ATOL = 1e-4

# the card's published peaks (NVIDIA H100 SXM data sheet, at the 700 W limit):
# HBM bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
# device ms: calls captured back to back in one CUDA graph, replays timed
GRAPH_CALLS, GRAPH_REPLAYS = 100, 7

REPLACES = {
    "k1": "combo_avs_tpu/ops/deform_attn_pallas.py:408",
    "k2": "combo_avs_tpu/ops/deform_attn_pallas.py:488",
    "k3": "combo_avs_tpu/ops/point_sample_pallas.py:98",
    "k5": "combo_avs_tpu/ops/point_sample_pallas.py:371",
    "k4": "combo_avs_tpu/ops/point_sample_pallas.py:112",
    "k4_dxy": "combo_avs_tpu/ops/point_sample_pallas.py:131",
    "k6": "combo_avs_tpu/ops/gather_pallas.py:49",
    "k7": "combo_avs_tpu/ops/seminf_pallas.py:67",
}
# the matcher's cost, fused (csrc/match_cost.cu), against its composition
# (HungarianMatcher.cost_matrix, then nan_to_num): both sum the same fp32
# terms over the points in another order and take exp, log1p and the
# reciprocal through other code; costs lie in [0, about 12], so the kernel
# is held to this share of the largest valid cost (tests/
# test_torch_matchcost_card.py); invalid slots are BIG_COST on both sides
MATCH_COST_RTOL = 3e-5
MUFU_PER_SM_CLOCK = 16  # transcendental (MUFU) results an SM a clock on Hopper


def log(*args):
    print(*args, flush=True)


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    return smi


def phase_build() -> None:
    from combo_avs_torch.ops import (_build, deform_attn_cuda, gather_cuda, match_cost_cuda,
                                     point_sample_cuda, seminf_cuda)

    sources = [deform_attn_cuda.SOURCE, deform_attn_cuda.BWD_SOURCE, *point_sample_cuda.SOURCES,
               seminf_cuda.SOURCE, gather_cuda.SOURCE, match_cost_cuda.SOURCE]
    t0 = time.perf_counter()
    _build.load_all(sources)
    dt = time.perf_counter() - t0
    log(f"[build] {len(sources)} sources in {dt:.2f} s: "
        + ", ".join(f"{s} -> {_build.library_path(s)}" for s in sources))


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes moved over the HBM rate or
    float32 operations over the peak rate, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_inputs(Bn, M, D, P, levels, Lq, dtype, device, seed):
    """Random value, locations in [-0.2, 1.2] (so some corners fall outside a
    level) with a quarter of them on exact pixel centres (integer sample
    coordinates), and softmax weights."""
    rng = np.random.RandomState(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = rng.randn(Bn, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (Bn, Lq, M, L, P, 2)).astype(np.float32)
    for l, (h, w) in enumerate(levels):
        sel = rng.rand(Bn, Lq, M, P) < 0.25
        px = (rng.randint(-1, w + 1, sel.shape) + 0.5) / w
        py = (rng.randint(-1, h + 1, sel.shape) + 0.5) / h
        loc[:, :, :, l, :, 0] = np.where(sel, px, loc[:, :, :, l, :, 0])
        loc[:, :, :, l, :, 1] = np.where(sel, py, loc[:, :, :, l, :, 1])
    logits = rng.randn(Bn, Lq, M, L * P).astype(np.float32)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).reshape(Bn, Lq, M, L, P)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(value).to(dtype), to(loc), to(w)


def point_inputs(N, H, W, C, P, device, seed):
    """feat [N, H, W, C] and points [N, P, 2]: uniform in [-0.1, 1.1] (corners
    outside the image), a quarter on exact pixel centres."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(N, H, W, C).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (N, P, 2)).astype(np.float32)
    sel = rng.rand(N, P) < 0.25
    pts[..., 0] = np.where(sel, (rng.randint(0, W, sel.shape) + 0.5) / W, pts[..., 0])
    pts[..., 1] = np.where(sel, (rng.randint(0, H, sel.shape) + 0.5) / H, pts[..., 1])
    return torch.from_numpy(feat).to(device), torch.from_numpy(pts).to(device)


def corners_inside(x: torch.Tensor, y: torch.Tensor, H: int, W: int) -> int:
    """How many of the four bilinear corners of the pixel coordinates (x, y)
    lie inside an H x W grid: the corners a kernel reads for this data."""
    x0, y0 = torch.floor(x), torch.floor(y)
    n = 0
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            n += int(((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).sum())
    return n


def deform_corners(levels, loc: torch.Tensor) -> int:
    """In-level corners of every sampling point of locations [B, Lq, M, L, P, 2]."""
    return sum(corners_inside(loc[:, :, :, l, :, 0] * W - 0.5, loc[:, :, :, l, :, 1] * H - 0.5,
                              H, W) for l, (H, W) in enumerate(levels))


def point_corners(points: torch.Tensor, H: int, W: int) -> int:
    return corners_inside(points[..., 0] * W - 0.5, points[..., 1] * H - 0.5, H, W)


def call_time_ms(fn, iters=20, warmup=3) -> float:
    """Call ms: the median over `iters` of one eager call each, between two
    CUDA events on an idle stream, so the wrapper's host time counts too, as
    the eager main path pays it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_time_ms(fn) -> tuple:
    """Device ms: GRAPH_CALLS back-to-back calls captured in one CUDA graph,
    replayed between two events, over GRAPH_CALLS; the median of
    GRAPH_REPLAYS replays. No host time enters. Should the capture fail, the
    device time per call of every kernel the calls ran, from torch.profiler.
    Returns (ms, source), the source "graph" or "profiler"."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_CALLS):
                fn()
        graph.replay()
        times = []
        for _ in range(GRAPH_REPLAYS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / GRAPH_CALLS)
        del graph
        return float(np.median(times)), "graph"
    except RuntimeError as e:
        log(f"[timing] CUDA graph capture failed ({str(e).splitlines()[0]}); the device time "
            "comes from torch.profiler")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(GRAPH_CALLS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    return sum(e.device_time for e in events) / 1e3 / GRAPH_CALLS, "profiler"


def host_us(fn, calls=200) -> float:
    """Host us per call: the host clock around `calls` eager calls that
    enqueue without waiting (the stream runs behind), over `calls`."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def timings(fn, plain=None, library=None) -> dict:
    """The kernel's device ms (with its source), call ms and host us per
    call; the same for the library call computing the same function; the
    plain version's call ms (it repeats the kernel's arithmetic in many ops
    and is no yardstick of speed)."""
    t = dict(zip(("ms", "device_source"), device_time_ms(fn)), call_ms=call_time_ms(fn),
             host_us=host_us(fn))
    if plain is not None:
        t["plain_ms"] = call_time_ms(plain)
    if library is not None:
        t.update(zip(("library_ms", "library_source"), device_time_ms(library)),
                 library_call_ms=call_time_ms(library), library_host_us=host_us(library))
    return t


def describe(t: dict, library: str = "library") -> str:
    s = (f"kernel {t['ms']:.4f} ms device ({t['device_source']}), {t['call_ms']:.4f} ms call, "
         f"{t['host_us']:.1f} us host")
    if "library_ms" in t:
        s += (f"; {library} {t['library_ms']:.4f} ms device ({t['library_source']}), "
              f"{t['library_call_ms']:.4f} ms call, {t['library_host_us']:.1f} us host")
    if "plain_ms" in t:
        s += f"; plain {t['plain_ms']:.4f} ms call"
    return s


def compare(tag: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """Max abs error and max abs error over max |want|; raises above `tol`."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tag}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    max_abs = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    rel = max_abs / scale if scale > 0 else max_abs
    log(f"{tag}: {tuple(got.shape)} max_abs_err {max_abs:.3e} max_rel_err {rel:.3e} "
        f"(vs max|plain| {scale:.4g}; tol {tol:g})")
    if not np.isfinite(max_abs) or rel > tol:
        raise AssertionError(f"{tag}: kernel disagrees with plain: rel {rel:.3e} > {tol:g}")
    return {"max_abs_err": max_abs, "max_rel_err": rel}


def phase_k1(dev: torch.device) -> dict:
    """K1 against the plain version under both launch plans: the plan's own
    choice (staged where the (frame, head) value slice fits the card's
    opt-in shared memory, its query chunk made for the frame count and the
    card's SMs; grouped, a smaller block on the whole slice or on an fp32
    channel group of it, where the 32-warp staged block does not fit) through the
    wrapper, and global forced (the plan at an
    opt-in limit of 0), at the eval shape (20 frames), the training shape
    (40), a ragged shape and the TTA branches' shapes, fp32 and bf16. Both
    plans are timed at the eval and training shapes and at TTA's 384^2
    (grouped), the plain version beside the chosen one."""
    from combo_avs_torch.ops import deform_attn_cuda as k1
    from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

    optin, sms = k1.smem_optin(dev.index), k1.sm_count(dev.index)
    Lq = sum(h * w for h, w in K1_LEVELS)  # encoder queries = all tokens
    train = dict(K1_SHAPE, B=TRAIN_N)
    # ragged: D=16 (half a warp of lanes), Lq*M not a multiple of the block
    ragged_levels, ragged = ((3, 5), (6, 10)), dict(B=3, M=3, D=16, P=4)
    result = {"smem_optin": optin}
    cases = [  # name, value dtype, levels, shape, queries, tolerance
        ("fp32", torch.float32, K1_LEVELS, K1_SHAPE, Lq, K1_TOL_FP32),
        ("bf16", torch.bfloat16, K1_LEVELS, K1_SHAPE, Lq, K1_TOL_BF16),
        ("train_fp32", torch.float32, K1_LEVELS, train, Lq, K1_TOL_FP32),
        ("train_bf16", torch.bfloat16, K1_LEVELS, train, Lq, K1_TOL_BF16),
        ("ragged_fp32", torch.float32, ragged_levels, ragged, 37, K1_TOL_FP32),
        ("ragged_bf16", torch.bfloat16, ragged_levels, ragged, 37, K1_TOL_BF16),
        # the TTA branches' shapes (bf16, 20 frames) at 128^2 and 384^2; 384^2
        # also in fp32 (TEST.BF16 off), where the grouped plan runs
        *((f"tta{s}_bf16", torch.bfloat16, tta_levels(s), K1_SHAPE,
           sum(h * w for h, w in tta_levels(s)), K1_TOL_BF16) for s in (128, 384)),
        ("tta384_fp32", torch.float32, tta_levels(384), K1_SHAPE,
         sum(h * w for h, w in tta_levels(384)), K1_TOL_FP32),
    ]
    with torch.inference_mode():
        for name, dtype, levels, shp, lq, tol in cases:
            value, loc, w = k1_inputs(shp["B"], shp["M"], shp["D"], shp["P"], levels, lq,
                                      dtype, dev, seed=len(name))
            want = ms_deform_attn_plain(value, levels, loc, w)
            plan_at = lambda limit: k1.fwd_launch_plan(  # noqa: E731
                levels, shp["B"], lq, shp["M"], shp["D"], shp["P"], value.element_size(), limit,
                sms)
            chosen = plan_at(optin)
            # a staged plan at an unbounded limit raises at launch if it does not fit:
            # where the choice is global, no staged plan fits and none is forced
            other = plan_at(0) if chosen.kernel != "global" else None
            timed = levels == K1_LEVELS or name.startswith("tta384")
            row = {"chosen": chosen.kernel, "plans": {}}
            # the chosen plan runs as the wrapper picks it; the other is forced
            for plan, forced in ((chosen, None), (other, other))[:2 if other else 1]:
                fn = lambda: k1.ms_deform_attn_cuda(value, levels, loc, w, plan=forced)  # noqa: E731
                err = compare(f"[k1] {name} ({plan.kernel}, levels {levels})", fn(), want, tol)
                if not timed:
                    continue
                t = timings(fn, plain=(lambda: ms_deform_attn_plain(value, levels, loc, w))
                            if plan is chosen else None)
                # one FMA per in-level corner and channel
                bd = bound(nbytes(value, loc, w, want), 2 * shp["D"] * deform_corners(levels, loc))
                log(f"[k1] {name} [{shp['B']},{lq},{shp['M']},{shp['D']}]: {plan.kernel} plan "
                    f"{plan}: {describe(t)}; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({bd['bound_ms'] / t['ms']:.0%} of it)")
                row["plans"][plan.kernel] = dict(err, plan=plan._asdict(), **t, **bd)
            if timed:
                ms = {kn: v["ms"] for kn, v in row["plans"].items()}
                log(f"[k1] {name}, device ms: " + ", ".join(f"{kn} {v:.4f}" for kn, v in ms.items())
                    + f" (chosen: {chosen.kernel}); the card's opt-in limit {optin} bytes "
                    "per block")
                result[name] = dict(row["plans"][chosen.kernel], **row)
    return result


def tta_levels(s: int) -> tuple:
    """The pixel decoder's levels (res5, res4, res3) for s x s frames."""
    return tuple((s // r, s // r) for r in (32, 16, 8))


def _one_level(rows: int) -> tuple:
    """An (H, W) level of exactly `rows` positions, as square as rows allows."""
    h = max(d for d in range(1, int(rows ** 0.5) + 1) if rows % d == 0)
    return h, rows // h


def phase_k2(dev: torch.device) -> dict:
    """K2 against autograd of the plain forward under both launch plans: the
    training shape (40 frames) through the plan's choice (level_slice) and
    forced through the global kernel (the plan at an opt-in limit of 0), a
    ragged shape, and a largest level one row more than the level-slice
    kernel's shared memory takes at the card's opt-in limit, through the
    plan's own choice (global). In bf16 (the AMP step's value, grad,
    locations and weights): the AVSS training shape (80 frames, level_slice)
    and the ragged shape under both plans, against the plain version's fp32
    autograd on the same bf16-rounded inputs, each gradient rounded to the
    kernel's output type. Both plans are timed at the fp32 training shape,
    the level-slice plan at the bf16 one."""
    from combo_avs_torch.ops import deform_attn_cuda as k
    from combo_avs_torch.ops.deform_attn import ms_deform_attn_plain

    optin = k.smem_optin(dev.index)
    D, P = K1_SHAPE["D"], K1_SHAPE["P"]
    fits = max(r for r in range(1, optin // (8 * D) + 1)
               if k.level_slice_bytes(r, D, P) <= optin)
    over = _one_level(fits + 1)
    Lq = sum(h * w for h, w in K1_LEVELS)
    train = dict(K1_SHAPE, B=TRAIN_N)
    avss = dict(K1_SHAPE, B=AVSS_N)
    ragged_levels, ragged = ((3, 5), (6, 10)), dict(B=3, M=3, D=16, P=4)
    f32, bf16 = torch.float32, torch.bfloat16
    result = {"smem_optin": optin}
    cases = [  # name, levels, shape, queries, the opt-in limit the plan is made for, its
        # kernel, the value type
        ("train", K1_LEVELS, train, Lq, optin, "level_slice", f32),
        ("train_global", K1_LEVELS, train, Lq, 0, "global", f32),
        ("ragged", ragged_levels, ragged, 37, optin, "level_slice", f32),
        ("over_optin", ((7, 7), over), dict(B=2, M=2, D=D, P=P), 100, optin, "global", f32),
        ("avss_bf16", K1_LEVELS, avss, Lq, optin, "level_slice", bf16),
        ("ragged_bf16", ragged_levels, ragged, 37, optin, "level_slice", bf16),
        ("ragged_bf16_global", ragged_levels, ragged, 37, 0, "global", bf16),
    ]
    inputs = {}
    for name, levels, shp, lq, plan_optin, kernel, dtype in cases:
        esize = torch.tensor([], dtype=dtype).element_size()
        plan = k.bwd_launch_plan(levels, lq, shp["M"], shp["D"], shp["P"], plan_optin, esize)
        if plan.kernel != kernel:
            raise AssertionError(f"[k2] {name}: the launch plan chose {plan}, expected {kernel}")
        key = (levels, tuple(sorted(shp.items())), lq, dtype)
        if key not in inputs:  # the cases of one shape and type share their inputs
            value, loc, w = k1_inputs(shp["B"], shp["M"], shp["D"], shp["P"], levels, lq,
                                      torch.float32, dev, seed=10 + len(name))
            g = torch.randn((shp["B"], lq, shp["M"] * shp["D"]), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(len(name)))
            value, loc, w, g = (t.to(dtype) for t in (value, loc, w, g))
            # the plain version in fp32 on the kernel's own (rounded) inputs
            leaves = [t.float().requires_grad_() for t in (value, loc, w)]
            out = ms_deform_attn_plain(leaves[0], levels, leaves[1], leaves[2])
            want = [t.to(dtype) for t in torch.autograd.grad(out, leaves, g.float(),
                                                            retain_graph=True)]
            inputs[key] = (value, loc, w, g, leaves, out, want)
        value, loc, w, g, leaves, out, want = inputs[key]
        # the chosen plan is passed only where it is forced, so that the
        # other cases run the wrapper's own choice
        forced = plan if plan_optin != optin else None
        fn = lambda: k.ms_deform_attn_bwd_cuda(value, levels, loc, w, g, plan=forced)  # noqa: E731
        got = fn()
        tol = TOL_FP32 if dtype == f32 else K2_TOL_BF16
        errs = [compare(f"[k2] {name} ({plan.kernel}, levels {levels}) d{n}", a, b, tol)
                for n, a, b in zip(("value", "loc", "weights"), got, want)]
        if name not in ("train", "train_global", "avss_bf16"):
            continue
        plain = lambda: torch.autograd.grad(out, leaves, g.float(), retain_graph=True)  # noqa: E731
        t = timings(fn, plain=plain if name != "train_global" else None)
        # per in-level corner and channel: <g, v>, three FMAs into the
        # weight and the two coordinate sums, the dvalue term a*w*g and its add
        bd = bound(nbytes(value, loc, w, g, *got), 10 * shp["D"] * deform_corners(levels, loc))
        log(f"[k2] {name} [{shp['B']},{lq},{shp['M']},{shp['D']}] {str(dtype)[6:]}: "
            f"{plan.kernel} plan {plan}: {describe(t)} (autograd backward); "
            f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
            f"({bd['bound_ms'] / t['ms']:.0%} of it)")
        row = "bf16" if dtype == bf16 else plan.kernel
        result[row] = dict(max_abs_err=max(e["max_abs_err"] for e in errs),
                           max_rel_err=max(e["max_rel_err"] for e in errs),
                           plan=plan._asdict(), **t, **bd)
    ls, gl = result["level_slice"], result["global"]
    log(f"[k2] train, device ms: level_slice {ls['ms']:.4f} against global {gl['ms']:.4f} "
        f"({ls['ms'] / gl['ms']:.2f}x); bf16 at [{AVSS_N},{Lq},8,32] level_slice "
        f"{result['bf16']['ms']:.4f}; the card's opt-in limit {optin} bytes per block")
    return result


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a contiguous tensor 4 bytes into its allocation."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def _grid(points: torch.Tensor) -> torch.Tensor:
    """[N, P, 2] points in [0, 1] -> F.grid_sample's [N, P, 1, 2] grid in [-1, 1]."""
    return (2.0 * points - 1.0)[:, :, None, :].contiguous()


def phase_point_sample(dev: torch.device) -> dict:
    """K3/K5 (forward) and K4 (image and point gradients) against the plain
    version and its autograd, at every training shape, with F.grid_sample
    (and its backward) as the library yardstick."""
    import torch.nn.functional as F

    from combo_avs_torch.ops import point_sample_cuda as k
    from combo_avs_torch.ops.grid_sample import point_sample_plain

    M, N, h, H, P = TRAIN_M, TRAIN_N, MASK_HW, GT_HW, NUM_POINTS
    fwd_cases = [  # name, feat [N, H, W, C], points
        ("k3_oversample", (M, h, h, 1), 3 * P),  # criterion: 3x candidates on the logits
        ("k3_point_logits", (M, h, h, 1), P),  # criterion: the differentiable logits
        ("k3_point_labels", (M, H, H, 1), P),  # criterion: the target masks
        ("k3_matcher_targets", (N, H, H, TRAIN_K), P),  # matcher: the target masks
        ("k5_matcher_preds", (N, h, h, NUM_QUERIES), P),  # matcher: 100 masks, shared points
    ]
    shapes = []
    with torch.inference_mode():
        # the launch plan's edges, checked and not timed: a ragged C > 4, odd
        # P (scalar tails), C = 3 and 4 staged and not, an image one float
        # over the staging limit, more images than grid rows, and inputs 4
        # bytes off their 16-byte alignment
        for i, (name, (n, hh, ww, c), p, misalign) in enumerate(POINT_EDGE_CASES):
            feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=50 + i)
            want = point_sample_plain(feat, pts)
            if misalign:
                feat, pts = misaligned(feat), misaligned(pts)
            compare(f"[k3/k5] {name}", k.point_sample_fwd_cuda(feat, pts), want, TOL_FP32)
        for i, (name, (n, hh, ww, c), p) in enumerate(fwd_cases):
            feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=20 + i)
            got = k.point_sample_fwd_cuda(feat, pts)
            err = compare(f"[k3/k5] {name}", got, point_sample_plain(feat, pts), TOL_FP32)
            nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
            t = timings(lambda: k.point_sample_fwd_cuda(feat, pts),
                        plain=lambda: point_sample_plain(feat, pts),
                        library=lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                                      padding_mode="zeros", align_corners=False))
            # one FMA per in-image corner and channel
            bd = bound(nbytes(feat, pts, got), 2 * c * point_corners(pts, hh, ww))
            log(f"[k3/k5] {name}: [{n},{hh},{ww},{c}] at {p} points: "
                f"{describe(t, 'F.grid_sample')}; bound {bd['bound_ms']:.4f} ms by "
                f"{bd['bound_by']} ({bd['bound_ms'] / t['ms']:.0%} of it)")
            shapes.append(dict(name=name, shape=[n, hh, ww, c], points=p, **t, **err, **bd))

    # K4 dimg under both launch plans: the plan's choice through the wrapper,
    # the other forced (global always takes a shape; staged only C <= 4 and
    # an image that fits), against the plain version's autograd
    optin, sms = k.smem_optin(dev.index), k.sm_count(dev.index)
    # images whose staged shared memory (4 bytes an element) fills the
    # card's opt-in limit exactly, and one element more
    fits = max(w for w in range(optin // 4 - 4, optin // 4 + 1)
               if k.dimg_smem_bytes(1, w, 1) <= optin)
    edges = [("at_smem_limit", (16, 1, fits, 1), 3001, False, "staged"),
             ("one_over_smem_limit", (16, 1, fits + 1, 1), 3001, False, "global")]
    dimg = {}
    for i, (name, (n, hh, ww, c), p, misalign, kernel) in enumerate(DIMG_CASES + edges):
        feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=60 + i)
        dout = torch.randn((n, p, c), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(i))
        f_ = feat.clone().requires_grad_()
        out = point_sample_plain(f_, pts)
        want = torch.autograd.grad(out, f_, dout, retain_graph=True)[0]
        if misalign:
            pts, dout = misaligned(pts), misaligned(dout)
        chosen = k.dimg_launch_plan(n, hh, ww, c, p, pts.data_ptr(), dout.data_ptr(), sms, optin)
        if chosen.kernel != kernel:
            raise AssertionError(f"[k4] dimg {name}: the launch plan chose {chosen}, "
                                 f"expected {kernel}")
        plans = [(chosen, None)]
        if chosen.kernel == "staged":  # global at an opt-in limit of 0
            other = k.dimg_launch_plan(n, hh, ww, c, p, 0, 0, sms, 0)
            plans.append((other, other))
        else:  # staged where it can take the shape: the plan for a card of one SM
            other = k.dimg_launch_plan(n, hh, ww, c, p, pts.data_ptr(), dout.data_ptr(), 1, optin)
            if other.kernel == "staged":
                plans.append((other, other))
        for plan, forced in plans:
            fn = lambda: k.point_sample_dimg_cuda(pts, dout, (hh, ww), plan=forced)  # noqa: E731
            err = compare(f"[k4] dimg {name} ({plan.kernel}, [{n},{hh},{ww},{c}] at {p} "
                          f"points{', misaligned' if misalign else ''})", fn(), want, TOL_FP32)
            if name != "train":
                continue
            got = fn()
            nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
            dlib = dout.permute(0, 2, 1)[..., None].contiguous()  # [N, C, P, 1]
            # the library's backward as autograd calls it for the image: one
            # ATen op (bilinear, zero padding, align_corners=False)
            lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
                dlib, nchw, grid, 0, 0, False, [True, False])
            plain = lambda: torch.autograd.grad(out, f_, dout, retain_graph=True)  # noqa: E731
            t = timings(fn, plain=plain if forced is None else None,
                        library=lib if forced is None else None)
            # a product and an add per in-image corner and channel
            bd = bound(nbytes(pts, dout, got), 2 * c * point_corners(pts, hh, ww))
            log(f"[k4] dimg {name}: {plan.kernel} plan {plan}: "
                f"{describe(t, 'grid_sampler_2d_backward')}; bound {bd['bound_ms']:.4f} ms by "
                f"{bd['bound_by']} ({bd['bound_ms'] / t['ms']:.0%} of it)")
            dimg[plan.kernel] = dict(err, plan=plan._asdict(), **t, **bd)
    # an inf among one image's gradients, through the staged plan: inf at
    # the point's four corners, as the plain version has it
    feat, pts = point_inputs(16, MASK_HW, MASK_HW, 1, 2048, dev, seed=70)
    pts[1, 7] = torch.tensor([10.3 / MASK_HW, 20.3 / MASK_HW], device=dev)  # 4 corners inside
    dout = torch.randn((16, 2048, 1), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(70))
    dout[1, 7, 0] = float("inf")
    if k.dimg_launch_plan(16, MASK_HW, MASK_HW, 1, 2048, pts.data_ptr(), dout.data_ptr(), sms,
                          optin).kernel != "staged":
        raise AssertionError("[k4] dimg inf_gradient: the launch plan did not stage it")
    f_ = feat.clone().requires_grad_()
    want = torch.autograd.grad(point_sample_plain(f_, pts), f_, dout)[0]
    got = k.point_sample_dimg_cuda(pts, dout, (MASK_HW, MASK_HW))
    finite = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), finite) or int((~finite).sum()) != 4:
        raise AssertionError("[k4] dimg with an inf gradient: the non-finite elements differ "
                             "from the plain version's")
    compare("[k4] dimg inf_gradient (finite elements)", got[finite], want[finite], TOL_FP32)

    st, gl = dimg["staged"], dimg["global"]
    log(f"[k4] dimg train, device ms: staged {st['ms']:.4f} against global {gl['ms']:.4f} "
        f"({st['ms'] / gl['ms']:.2f}x) and grid_sampler_2d_backward {st['library_ms']:.4f}; "
        f"the card's opt-in limit {optin} bytes per block, {sms} SMs")

    back = {}
    for name, (n, hh, ww, c), p in [("train", (M, h, h, 1), P), ("ragged", (3, 7, 5, 33), 101)]:
        feat, pts = point_inputs(n, hh, ww, c, p, dev, seed=40 + len(name))
        dout = torch.randn((n, p, c), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(len(name)))
        f_, p_ = feat.clone().requires_grad_(), pts.clone().requires_grad_()
        out = point_sample_plain(f_, p_)
        want_dp = torch.autograd.grad(out, p_, dout, retain_graph=True)[0]
        got_dp = k.point_sample_dxy_cuda(feat, pts, dout)
        e_xy = compare(f"[k4] {name} dxy", got_dp, want_dp, TOL_FP32)
        if name != "train":
            continue
        nchw, grid = feat.permute(0, 3, 1, 2).contiguous(), _grid(pts)
        dlib = dout.permute(0, 2, 1)[..., None].contiguous()  # [N, C, P, 1]
        t = timings(lambda: k.point_sample_dxy_cuda(feat, pts, dout),
                    plain=lambda: torch.autograd.grad(out, p_, dout, retain_graph=True),
                    library=lambda: torch.ops.aten.grid_sampler_2d_backward(
                        dlib, nchw, grid, 0, 0, False, [False, True]))
        # per point and channel: two corner differences, two weights, a sum
        # and an FMA with dout, for x and for y
        bd = bound(nbytes(feat, pts, dout, got_dp), 14 * c * n * p)
        log(f"[k4] dxy: [{n},{hh},{ww},{c}] at {p} points: "
            f"{describe(t, 'grid_sampler_2d_backward')} (autograd); bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        back["dxy"] = dict(e_xy, **t, **bd)
        del out
    return {"fwd": shapes, "dimg": dict(st, global_plan=gl), **back}


def seminf_inputs(N, Q, C, h, w, dtype, device, seed):
    """cls_sm [N, Q, C] (softmax over C + 1 classes, the last dropped), mask
    logits [N, Q, h, w] of spread 4 in `dtype`, and a 0/1 temporal mask [N]
    with most frames on."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, Q, C + 1)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    cls = (e / e.sum(-1, keepdims=True))[..., :C].astype(np.float32)
    mask = (rng.randn(N, Q, h, w) * 4).astype(np.float32)
    tm = (rng.rand(N) > 0.2).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(cls), to(mask).to(dtype), to(tm)


def phase_k7(dev: torch.device) -> dict:
    """K7 against the plain composition under both launch plans: the plan's
    choice through the wrapper and the pixel kernel forced (the patch kernel
    takes integer ratios of at least 2 only), at the eval tail's shape (fp32
    and bf16 masks), integer ratios other than 4, a ratio of 1 and a ragged
    one, each with the temporal mask on and off; both plans timed at the eval shape, with the
    time of the resize alone."""
    import torch.nn.functional as F

    from combo_avs_torch.ops import seminf_cuda as k

    result = {}
    x3 = dict(K7_SHAPE, N=4)  # 56^2 -> 168^2: ratio 3
    cases = [("fp32", torch.float32, K7_SHAPE, (SIZE, SIZE), TOL_FP32),
             ("bf16", torch.bfloat16, K7_SHAPE, (SIZE, SIZE), K7_TOL_BF16),
             ("x3_fp32", torch.float32, x3, (3 * MASK_HW, 3 * MASK_HW), TOL_FP32),
             ("x3_bf16", torch.bfloat16, x3, (3 * MASK_HW, 3 * MASK_HW), K7_TOL_BF16),
             ("x2x8_c5_fp32", torch.float32, dict(N=3, Q=9, C=5, h=7, w=6), (14, 48), TOL_FP32),
             ("ragged_fp32", torch.float32, dict(N=3, Q=7, C=5, h=5, w=9), (13, 31), TOL_FP32),
             ("same_size_fp32", torch.float32, dict(N=2, Q=3, C=8, h=6, w=6), (6, 6), TOL_FP32),
             # the TTA branches' masks (bf16) at 128^2 (7x: patch) and 384^2 (96 -> 224: pixel)
             ("tta128_bf16", torch.bfloat16, dict(K7_SHAPE, h=32, w=32), (SIZE, SIZE),
              K7_TOL_BF16),
             ("tta384_bf16", torch.bfloat16, dict(K7_SHAPE, h=96, w=96), (SIZE, SIZE),
              K7_TOL_BF16)]
    with torch.inference_mode():
        for name, dtype, shp, size, tol in cases:
            cls, mask, tm = seminf_inputs(shp["N"], shp["Q"], shp["C"], shp["h"], shp["w"],
                                          dtype, dev, seed=30 + len(name))
            chosen = k.launch_plan(shp["N"], shp["Q"], shp["C"], shp["h"], shp["w"], *size)
            integer = (size[0] % shp["h"] == 0 and size[1] % shp["w"] == 0
                       and min(size[0] // shp["h"], size[1] // shp["w"]) >= 2)
            if chosen.kernel != ("patch" if integer else "pixel"):
                raise AssertionError(f"[k7] {name}: the launch plan chose {chosen}")
            plans = [(chosen, None)]
            if chosen.kernel == "patch":
                pixel = k.pixel_plan(shp["Q"], shp["C"], *size)
                plans.append((pixel, pixel))
            row = {"chosen": chosen.kernel, "plans": {}}
            for plan, forced in plans:
                for temporal in (None, tm):
                    got = k.seminf_cuda(cls, mask, size, temporal, plan=forced)
                    err = compare(f"[k7] {name} ({plan.kernel}"
                                  f"{'' if temporal is None else ', temporal'})", got,
                                  k.semantic_inference_plain(cls, mask, size, temporal), tol)
                if name not in ("fp32", "bf16", "tta384_bf16"):
                    continue
                t = timings(lambda: k.seminf_cuda(cls, mask, size, plan=forced),
                            plain=(lambda: k.semantic_inference_plain(cls, mask, size))
                            if forced is None else None)
                # per (pixel, query): the bilinear sample (4 products, 3 sums
                # and the weights' share), the sigmoid (negate, exp, add,
                # reciprocal) and a multiply-add per class
                flops = shp["N"] * size[0] * size[1] * shp["Q"] * (12 + 2 * shp["C"])
                bd = bound(nbytes(cls, mask) + shp["N"] * shp["C"] * size[0] * size[1] * 4,
                           flops)
                log(f"[k7] {name}: mask {list(mask.shape)} -> {size}: {plan.kernel} plan "
                    f"{plan}: {describe(t)}; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({bd['bound_ms'] / t['ms']:.0%} of it)")
                row["plans"][plan.kernel] = dict(err, plan=plan._asdict(), **t, **bd)
            if name == "tta384_bf16":
                result[name] = row["plans"]["pixel"]
            if name not in ("fp32", "bf16"):
                continue
            # F.interpolate alone: a part of the plain version, not the same function
            resize = timings(lambda: F.interpolate(mask, size=size, mode="bilinear",
                                                   align_corners=False, antialias=False))
            pa, px = row["plans"]["patch"], row["plans"]["pixel"]
            log(f"[k7] {name}, device ms: patch {pa['ms']:.4f} against pixel {px['ms']:.4f} "
                f"({pa['ms'] / px['ms']:.2f}x); F.interpolate alone {resize['ms']:.4f} ms device "
                f"({resize['device_source']}), {resize['call_ms']:.4f} ms call, "
                f"{resize['host_us']:.1f} us host")
            result[name] = dict(pa, pixel_plan=px, resize_ms=resize["ms"],
                                resize_call_ms=resize["call_ms"])
    return result


def k6_inputs(G: int, NS: int, P: int, dev: torch.device):
    """Random points and top-k indices as the criterion makes them, with the
    edge indices 0 and NS - 1 in every row."""
    g = torch.Generator(device=dev).manual_seed(G)
    src = torch.rand((G, NS, 2), generator=g, device=dev)
    idx = torch.topk(torch.randn((G, NS), generator=g, device=dev), P, dim=-1).indices
    idx[:, 0], idx[:, -1] = 0, NS - 1
    return src, idx


def k6_floors(src: torch.Tensor, idx: torch.Tensor) -> dict:
    """The gather's device ms beside its floors, each in the CUDA-graph
    replay of `device_time_ms`, on its grid: an empty kernel
    (launch and tail), a streaming copy of the index into the output (the
    index and output bytes alone), the gather as replayed back to back
    (warm: what the replays leave of the source in L2) and the gather after
    a read of K6_FLUSH_BYTES, which evicts the source from L2 (cold: the
    pair's time less the read's own)."""
    from combo_avs_torch.ops import gather_cuda as k

    flush = torch.ones(K6_FLUSH_BYTES // 4, device=src.device)
    out = {f"{mode}_ms": device_time_ms(lambda m=mode: k.gather_floor_cuda(src, idx, m))[0]
           for mode in ("empty", "stream")}
    out["warm_ms"] = device_time_ms(lambda: k.gather_points_cuda(src, idx))[0]
    out["flush_ms"] = device_time_ms(lambda: flush.sum())[0]
    out["cold_ms"] = device_time_ms(
        lambda: (flush.sum(), k.gather_points_cuda(src, idx)))[0] - out["flush_ms"]
    return out


def phase_k6(dev: torch.device) -> dict:
    """K6 against torch.gather, exactly, at the criterion fallback's shape
    (indices from a top-k, as there) and at a ragged one, in int64 and int32
    indices; at the criterion's shape its times, its bound and its floors
    (`k6_floors`)."""
    from combo_avs_torch.ops import gather_cuda as k

    result = {}
    for name, (G, NS, P) in (("train", tuple(K6_SHAPE.values())), ("ragged", (3, 1500, 1001))):
        src, idx = k6_inputs(G, NS, P, dev)
        for index in (idx, idx.int()):
            got = k.gather_points_cuda(src, index)
            want = k.gather_points_plain(src, index)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"[k6] {name} {index.dtype}: differs from torch.gather")
            log(f"[k6] {name}: [{G}, {NS}, 2] -> {P}, {index.dtype} indices: equal to "
                "torch.gather")
        if name != "train":
            continue
        vec = k.points_per_thread(idx.element_size(), idx.data_ptr(), got.data_ptr())
        idx2 = idx[..., None].expand(-1, -1, 2)
        t = timings(lambda: k.gather_points_cuda(src, idx),
                    plain=lambda: k.gather_points_plain(src, idx),
                    library=lambda: torch.gather(src, 1, idx2))
        # the index and the output once, and each source point this data
        # reads (a top-k selects distinct points of its row)
        touched = int(torch.unique(idx + torch.arange(G, device=dev)[:, None] * NS).numel())
        bd = bound(nbytes(idx, got) + 8 * touched, 0)
        floors = k6_floors(src, idx)
        log(f"[k6] {name}: {vec} points a thread: {describe(t, 'torch.gather')}; bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bound_ms'] / t['ms']:.0%} of it)")
        log(f"[k6] {name}: floors, device ms on its grid: empty kernel "
            f"{floors['empty_ms']:.4f}, streaming copy of the index into the output "
            f"{floors['stream_ms']:.4f}, gather warm {floors['warm_ms']:.4f}, gather with the "
            f"source flushed from L2 {floors['cold_ms']:.4f} (the flush's read of "
            f"{K6_FLUSH_BYTES >> 20} MiB {floors['flush_ms']:.4f} taken off)")
        result = dict(max_abs_err=0.0, points_per_thread=vec, floors=floors, **t, **bd)
    return result


def matcher_inputs(N, Q, hw, P, K, C1, spread, device, seed):
    """One decoder output's matcher arguments (points, pred_logits,
    pred_masks, tgt_labels, tgt_masks, tgt_valid): mask logits of spread 4,
    points uniform in [0, 1) as the criterion draws them ("uniform") or in
    [-0.1, 1.1] with a quarter on the border and on pixel centres
    ("border"), bool target masks of random blobs at 4x the mask size, about
    a third of the slots invalid (the first of each frame valid)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    masks = (rng.randn(N, Q, h, w) * 4).astype(np.float32)
    if spread == "uniform":
        pts = rng.rand(N, P, 2).astype(np.float32)
    else:
        pts = rng.uniform(-0.1, 1.1, (N, P, 2)).astype(np.float32)
        edge = rng.choice(np.array([0.0, 1.0, 0.5 / w, 1 - 0.5 / w], np.float32), (N, P, 2))
        pts = np.where(rng.rand(N, P, 1) < 0.25, edge, pts)
    tgt = (rng.rand(N, K, h, w) > 0.6).repeat(4, axis=2).repeat(4, axis=3)
    labels = rng.randint(0, C1, (N, K))
    valid = rng.rand(N, K) > 0.33
    valid[:, 0] = True
    logits = (rng.randn(N, Q, C1) * 2).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(pts), to(logits), to(masks), to(labels), to(tgt), to(valid)


def compare_costs(tag: str, got: torch.Tensor, want: torch.Tensor, valid: torch.Tensor) -> dict:
    """The matcher's costs against the composition's: BIG_COST exactly where
    the composition has it (every invalid slot among them), every other cost
    within MATCH_COST_RTOL of the largest; raises otherwise."""
    from combo_avs_torch.losses.matcher import BIG_COST

    torch.cuda.synchronize()
    big = want == BIG_COST
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(got == BIG_COST, big)
            or not big[(~valid)[:, None, :].expand_as(big)].all()):
        raise AssertionError(f"{tag}: BIG_COST entries or shapes differ from the composition's")
    scale = float(want[~big].abs().max())
    max_abs = float((got[~big] - want[~big]).abs().max())
    log(f"{tag}: {tuple(got.shape)} max_abs_err {max_abs:.3e} over the valid costs (max "
        f"{scale:.4g}; tol {MATCH_COST_RTOL:g} of it), BIG_COST on {int(big.sum())} alike")
    if not max_abs <= MATCH_COST_RTOL * scale:
        raise AssertionError(f"{tag}: the kernel disagrees with the composition: {max_abs:.3e}")
    return {"max_abs_err": max_abs, "max_rel_err": max_abs / scale}


def phase_match_cost(dev: torch.device, smi: str) -> dict:
    """The matcher's fused cost (csrc/match_cost.cu) against its composition
    (HungarianMatcher.cost_matrix, then nan_to_num) at the training cells'
    shape (40 frames x 100 queries x 56^2 masks, 12544 points, K = 3, 2
    classes, invalid slots) and at AVSS's K = 12 and 72 classes: device ms, call
    ms and host us of the kernel (the target masks' K3 sampling outside it),
    its bound (bytes, fp32 operations or MUFU results, the largest), the
    composition's device and call ms, and one decoder output's whole cost on
    each side (the kernel's: the targets' copy, K3 and the kernel)."""
    from combo_avs_torch.losses.matcher import BIG_COST, HungarianMatcher, _targets_nhwc
    from combo_avs_torch.ops import match_cost_cuda as mc
    from combo_avs_torch.ops.deform_attn_cuda import sm_count
    from combo_avs_torch.ops.grid_sample import point_sample

    matcher = HungarianMatcher()
    weights = (matcher.cost_class, matcher.cost_mask, matcher.cost_dice)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    out = {}
    for name, (N, K, C1) in (("cells", (TRAIN_N, TRAIN_K, 2)), ("avss", (AVSS_N, AVSS_K, 72))):
        Q, hw, P = NUM_QUERIES, (MASK_HW, MASK_HW), NUM_POINTS
        args = matcher_inputs(N, Q, hw, P, K, C1, "uniform", dev, seed=90 + K)
        points, logits, masks, labels, tgt, valid = args

        def plain():
            return torch.nan_to_num(matcher.cost_matrix(*args), nan=BIG_COST, posinf=BIG_COST,
                                    neginf=-BIG_COST)

        want = plain()
        tgt_points = point_sample(_targets_nhwc(tgt), points)
        plan = mc.launch_plan(N, Q, *hw, K)
        fn = lambda: mc.match_cost_cuda(points, logits, masks, tgt_points, labels,  # noqa: E731
                                        valid, weights)
        err = compare_costs(f"[match_cost] {name}", fn(), want, valid)
        t = timings(fn)
        triples = N * Q * P
        # fp32 operations a (frame, query, point): the bilinear FMAs (8),
        # softplus both ways and the sigmoid around their transcendentals (8),
        # per slot three FMAs and 1 - t (7 K), the sigmoid sum (1); MUFU: exp,
        # log1p and the reciprocal
        bd = bound(nbytes(masks, points, tgt_points, logits, labels, valid, want),
                   triples * (17 + 7 * K))
        mufu_ms = 3 * triples / (MUFU_PER_SM_CLOCK * sm_count(dev.index) * mhz * 1e6) * 1e3
        if mufu_ms > bd["bound_ms"]:
            bd.update(bound_ms=mufu_ms, bound_by="mufu")
        log(f"[match_cost] {name}: masks [{N},{Q},{hw[0]},{hw[1]}] at {P} points, K = {K}, "
            f"C+1 = {C1}, plan {plan}: {describe(t)}; bound {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']} ({bd['bound_ms'] / t['ms']:.0%} of it; MUFU at {mhz:.0f} MHz "
            f"{mufu_ms:.4f} ms)")
        t_plain = dict(zip(("ms", "device_source"), device_time_ms(plain)),
                       call_ms=call_time_ms(plain))
        path = lambda: matcher.solved_costs([args])[0]  # noqa: E731
        compare_costs(f"[match_cost] {name} path", path(), want, valid)
        t_path = dict(zip(("ms", "device_source"), device_time_ms(path)),
                      call_ms=call_time_ms(path), host_us=host_us(path))
        log(f"[match_cost] {name}: one decoder output's cost, device / call ms: composition "
            f"{t_plain['ms']:.4f} / {t_plain['call_ms']:.4f}, kernel path (targets' copy, K3, "
            f"kernel) {t_path['ms']:.4f} / {t_path['call_ms']:.4f} ({t_path['host_us']:.1f} us "
            f"host) on {smi}")
        out[name] = dict(err, plan=plan._asdict(), **t, **bd, mufu_ms=mufu_ms,
                         plain_ms=t_plain["call_ms"], plain_device_ms=t_plain["ms"],
                         path_ms=t_path["ms"], path_call_ms=t_path["call_ms"],
                         path_host_us=t_path["host_us"])
    return out


def _batch(rng, dev):
    """uint8 frames and Maskige, fp32 log-mel, as the loader ships them."""
    return {
        "images": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
        "audio_log_mel": torch.from_numpy(rng.randn(B, T, 96, 64).astype(np.float32)).to(dev),
        "pre_masks": torch.from_numpy(rng.randint(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
    }


def train_batch(b, size, dev, seed):
    """A loader-format S4 training batch made on `dev`: uint8 frames and
    Maskiges, fp32 log-mel, K = 3 slots (the first two valid) of int labels
    and bool masks, the first frame of each video weighted."""
    g = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.zeros((b, T, TRAIN_K), dtype=torch.bool, device=dev)
    valid[..., :2] = True
    frame_weight = torch.zeros((b, T), device=dev)
    frame_weight[:, 0] = 1.0
    return {
        "images": torch.randint(0, 256, (b, T, size, size, 3), generator=g, device=dev,
                                dtype=torch.uint8),
        "audio_log_mel": torch.randn((b, T, 96, 64), generator=g, device=dev),
        "pre_masks": torch.randint(0, 256, (b, T, size, size, 3), generator=g, device=dev,
                                   dtype=torch.uint8),
        "labels": torch.randint(0, 2, (b, T, TRAIN_K), generator=g, device=dev),
        "masks": torch.rand((b, T, TRAIN_K, size, size), generator=g, device=dev) > 0.5,
        "valid": valid,
        "gt_temporal_mask": frame_weight,
    }


def reset_counts():
    from combo_avs_torch.ops import (deform_attn_cuda, gather_cuda, match_cost_cuda,
                                     point_sample_cuda, seminf_cuda)

    deform_attn_cuda.launches = deform_attn_cuda.bwd_launches = 0
    deform_attn_cuda.fwd_plan_launches.update(dict.fromkeys(deform_attn_cuda.fwd_plan_launches, 0))
    deform_attn_cuda.bwd_plan_launches.update(dict.fromkeys(deform_attn_cuda.bwd_plan_launches, 0))
    deform_attn_cuda.bwd_dtype_launches.update(
        dict.fromkeys(deform_attn_cuda.bwd_dtype_launches, 0))
    point_sample_cuda.fwd_launches = point_sample_cuda.dimg_launches = 0
    point_sample_cuda.dxy_launches = 0
    point_sample_cuda.dimg_plan_launches.update(dict.fromkeys(point_sample_cuda.dimg_plan_launches,
                                                              0))
    gather_cuda.launches = seminf_cuda.launches = match_cost_cuda.launches = 0
    seminf_cuda.plan_launches.update(dict.fromkeys(seminf_cuda.plan_launches, 0))


def read_counts() -> dict:
    from combo_avs_torch.ops import (deform_attn_cuda, gather_cuda, match_cost_cuda,
                                     point_sample_cuda, seminf_cuda)

    return {"k1": deform_attn_cuda.launches, "k2": deform_attn_cuda.bwd_launches,
            "k3": point_sample_cuda.fwd_launches, "k4_dimg": point_sample_cuda.dimg_launches,
            "k4_dxy": point_sample_cuda.dxy_launches, "k6": gather_cuda.launches,
            "k7": seminf_cuda.launches, "match_cost": match_cost_cuda.launches}


def phase_slice(model, smi: str, tag: str = "slice", profile: bool = False) -> dict:
    """make_eval_step at full width on NUM_BATCHES batches in fp32 and bf16:
    frames/s, and K1 (6 a forward) and K7 (1 a batch, patch plan) counted by
    plan; with `profile`, a profiler window over more steps of each."""
    from combo_avs_torch.ops import deform_attn_cuda, seminf_cuda
    from combo_avs_torch.train.train_step import make_eval_step

    dev = next(model.parameters()).device
    Lq = sum(h * w for h, w in K1_LEVELS)
    optin = deform_attn_cuda.smem_optin(dev.index)
    rng = np.random.RandomState(SEED)
    batches = [_batch(rng, dev) for _ in range(NUM_BATCHES)]
    steps = {name: make_eval_step(model, out_size=(SIZE, SIZE), bf16=(name == "bf16"))
             for name in ("fp32", "bf16")}
    for step in steps.values():  # warm-up (cuDNN algorithm choice), not counted
        step(batches[0])
    torch.cuda.synchronize()

    reset_counts()
    fps, k1_plans, k7_plans = {}, {}, {}
    for name, step in steps.items():
        before = read_counts()
        plans_before = dict(deform_attn_cuda.fwd_plan_launches)
        k7_before = dict(seminf_cuda.plan_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        n = after["k1"] - before["k1"]
        k1_plans[name] = {kn: c - plans_before[kn]
                          for kn, c in deform_attn_cuda.fwd_plan_launches.items()}
        # every K1 launch of the slice takes the plan fwd_launch_plan picks for its shape
        chosen = deform_attn_cuda.fwd_launch_plan(
            K1_LEVELS, B * T, Lq, K1_SHAPE["M"], K1_SHAPE["D"], K1_SHAPE["P"],
            2 if name == "bf16" else 4, optin, deform_attn_cuda.sm_count(dev.index)).kernel
        if k1_plans[name][chosen] != n:
            raise AssertionError(f"[{tag}] {name}: K1 launches by plan {k1_plans[name]}, "
                                 f"expected all {n} through {chosen}")
        # the eval tail's 4x upsample takes K7's patch plan
        k7_plans[name] = {kn: c - k7_before[kn] for kn, c in seminf_cuda.plan_launches.items()}
        if k7_plans[name] != {"pixel": 0, "patch": NUM_BATCHES}:
            raise AssertionError(f"[{tag}] {name}: K7 launches by plan {k7_plans[name]}, "
                                 f"expected all {NUM_BATCHES} through patch")
        for o in outs:
            if tuple(o.shape) != (B * T, 2, SIZE, SIZE) or o.dtype != torch.float32:
                raise AssertionError(f"[{tag}] {name}: output {tuple(o.shape)} {o.dtype}")
            if not bool(torch.isfinite(o).all()) or float(o.min()) < 0:
                raise AssertionError(f"[{tag}] {name}: output not finite and non-negative")
        want = {k: before[k] + {"k1": 6, "k7": 1}.get(k, 0) * NUM_BATCHES for k in before}
        if after != want:
            raise AssertionError(f"[{tag}] {name}: launches {after} (before {before}) for "
                                 f"{NUM_BATCHES} forwards, expected {want}: K1 6 and K7 1 "
                                 "per forward")
        fps[name] = NUM_BATCHES * B * T / dt
        log(f"[{tag}] {name}: {NUM_BATCHES} x [{B}x{T}x{SIZE}^2] -> {tuple(outs[0].shape)} "
            f"range [{float(outs[0].min()):.4f}, {float(outs[0].max()):.4f}], "
            f"K1 launches {n} (by plan {k1_plans[name]}), K7 {after['k7'] - before['k7']} "
            f"(by plan {k7_plans[name]}), "
            f"{fps[name]:.1f} frames/s on {smi} "
            f"(TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN {torch.backends.cudnn.allow_tf32})")
    out = {"launches": read_counts(), "fps": fps, "k1_plans": k1_plans, "k7_plans": k7_plans}
    if profile:
        out["profile"] = {name: profile_window(f"{tag} {name}", lambda: step(batches[0]),
                                               B * T / fps[name] * 1e3)
                          for name, step in steps.items()}
    return out


def phase_eval_entry(model, smi: str) -> dict:
    """The S4 evaluation entry point at full width: a synthetic val tree,
    the model through a reference `.pth` and back, `evaluate` at batch 4 in
    fp32 and bf16 (K7 once per batch, K1 six times), then fp32 again with the
    plain semantic inference on the card, whose metrics must agree, and fp32
    with the metrics on COMBO_EVAL_PROCS=2 worker processes forked from this
    process (which holds a CUDA context), whose metrics must be equal."""
    import contextlib
    import os
    import tempfile
    from unittest import mock

    from combo_avs_torch.data.catalogs import register_all
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.models.meta_arch import MaskFormer
    from combo_avs_torch.ops import seminf_cuda
    from combo_avs_torch.train.checkpoint import (load_reference_checkpoint,
                                                  save_reference_checkpoint)
    from combo_avs_torch.train.evaluate import evaluate

    batches = -(-EVAL_VIDEOS // EVAL_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_s4(tmp, 0, EVAL_VIDEOS, size=SIZE)
        register_all(tmp)
        path = f"{tmp}/model_best.pth"
        save_reference_checkpoint(model, path)
        loaded = MaskFormer()  # on the current CUDA device
        load_reference_checkpoint(loaded, path)
        for k, v in model.state_dict().items():
            if not torch.equal(loaded.state_dict()[k], v):
                raise AssertionError(f"[eval-entry] {k} changed through the .pth")
        loaded.eval()
        log(f"[eval-entry] {EVAL_VIDEOS} synthetic S4 val videos x {T} frames x {SIZE}^2 and "
            f"the .pth round trip in {time.perf_counter() - t0:.1f} s")
        runs = (("fp32", False, True, 0), ("bf16", True, True, 0),
                ("fp32_plain_tail", False, False, 0), ("fp32_procs2", False, True, 2))
        for name, bf16, fused, procs in runs:
            # the plain tail: semantic_inference is told the kernel takes no call
            tail = contextlib.nullcontext() if fused else mock.patch.object(
                seminf_cuda, "kernel_takes", lambda *a: False)
            env = mock.patch.dict(os.environ, {"COMBO_EVAL_PROCS": str(procs)})
            with tail, env:
                torch.cuda.synchronize()
                reset_counts()
                res, tm = evaluate(loaded, "avss4_sem_seg_val", batch_size=EVAL_BATCH, bf16=bf16,
                                   size=SIZE)
                counts = read_counts()
            want = {k: {"k1": 6 * batches, "k7": batches if fused else 0}.get(k, 0)
                    for k in counts}
            if counts != want:
                raise AssertionError(f"[eval-entry] {name}: launches {counts}, expected {want}")
            m = res["sem_seg"]
            if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
                raise AssertionError(f"[eval-entry] {name}: metrics out of range: {m}")
            log(f"[eval-entry] {name}: mIoU {m['mIoU']:.4f}, f_score {m['f_score']:.4f}; "
                f"{tm['videos']} videos, {tm['frames']} frames in {tm['total_s']:.3f} s "
                f"(data {tm['data_s']:.3f}, compute {tm['compute_s']:.3f}, eval "
                f"{tm['eval_s']:.3f}): {tm['videos'] / tm['total_s']:.2f} videos/s, "
                f"{tm['frames'] / tm['total_s']:.1f} frames/s; launches {counts} on {smi}")
            out[name] = dict(metrics=m, timing=tm, launches=counts)
    a, b = out["fp32"]["metrics"], out["fp32_plain_tail"]["metrics"]
    if any(abs(a[k] - b[k]) > EVAL_METRIC_ATOL for k in a):
        raise AssertionError(f"[eval-entry] K7 {a} and the plain tail {b} disagree beyond "
                             f"{EVAL_METRIC_ATOL}")
    log(f"[eval-entry] K7 against the plain tail, fp32: {a} vs {b} (atol {EVAL_METRIC_ATOL})")
    if out["fp32_procs2"]["metrics"] != a:
        raise AssertionError(f"[eval-entry] metrics on 2 worker processes "
                             f"{out['fp32_procs2']['metrics']} differ from inline {a}")
    log(f"[eval-entry] metrics on 2 forked worker processes equal the inline ones")
    return out


def phase_jpeg(smi: str) -> dict:
    """The port's JPEG codec (`combo_avs_torch/native/jpeg.c`), built with
    the host compiler from the checkout: synthetic frames (the synthetic
    trees' content) at 224^2 and at an AVSBench source size, 1280 x 720,
    encoded at quality JPEG_QUALITY and decoded back at 4:2:0, 4:4:4 and
    gray; each round trip above its PSNR floor; ms per frame of each. Its
    byte equality with libjpeg is held on the CPU (tests/test_torch_jpeg.py:
    cv2 is not on this machine)."""
    from combo_avs_torch.data import jpeg
    from combo_avs_torch.data.synth import _video_frames
    from combo_avs_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_host(jpeg.SOURCE)
    log(f"[jpeg] {jpeg.SOURCE} -> {_build.host_library_path(jpeg.SOURCE)} in "
        f"{time.perf_counter() - t0:.2f} s (host compiler {' '.join(_build.find_cc())})")
    rng = np.random.RandomState(SEED)
    out = {}
    for h, w in JPEG_SIZES:
        frame = _video_frames(rng, 3, 1, max(h, w))[0][0][:h, :w]
        reps = 20 if h * w <= SIZE * SIZE else 5
        for sub in ("420", "444", "gray"):
            img = np.ascontiguousarray(frame[..., 1]) if sub == "gray" else frame
            t0 = time.perf_counter()
            for _ in range(reps):
                data = jpeg.encode_jpeg(img, JPEG_QUALITY, "444" if sub == "444" else "420")
            enc_ms = (time.perf_counter() - t0) / reps * 1e3
            t0 = time.perf_counter()
            for _ in range(reps):
                back = jpeg.decode_jpeg(data, gray=sub == "gray")
            dec_ms = (time.perf_counter() - t0) / reps * 1e3
            if back.shape != img.shape:
                raise AssertionError(f"[jpeg] {h}x{w} {sub}: decoded {back.shape}, wrote "
                                     f"{img.shape}")
            mse = float(((back.astype(np.float64) - img) ** 2).mean())
            psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
            if psnr < JPEG_PSNR_FLOOR[sub]:
                raise AssertionError(f"[jpeg] {h}x{w} {sub}: PSNR {psnr:.2f} dB below "
                                     f"{JPEG_PSNR_FLOOR[sub]}")
            log(f"[jpeg] {h}x{w} {sub} q{JPEG_QUALITY}: {len(data)} bytes, PSNR {psnr:.2f} dB "
                f"(floor {JPEG_PSNR_FLOOR[sub]}); encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms "
                f"a frame (host, {reps} frames) on {smi}")
            out[f"{h}x{w}_{sub}"] = {"bytes": len(data), "psnr_db": psnr, "encode_ms": enc_ms,
                                     "decode_ms": dec_ms}
    return out


def tta_plans_per_batch(dev: torch.device, frames: int) -> dict:
    """K1 and K7 launches by plan in one TTA batch of `frames` frames in
    bf16 with flip, as the launch-plan functions choose them at each of
    TTA_SCALES: K1 6 a forward (the encoder layers), K7 1."""
    from combo_avs_torch.ops import deform_attn_cuda, seminf_cuda

    optin, sms = deform_attn_cuda.smem_optin(dev.index), deform_attn_cuda.sm_count(dev.index)
    k1 = dict.fromkeys(deform_attn_cuda.fwd_plan_launches, 0)
    k7 = dict.fromkeys(seminf_cuda.plan_launches, 0)
    for s in TTA_SCALES:
        levels = tta_levels(s)
        plan = deform_attn_cuda.fwd_launch_plan(levels, frames, sum(h * w for h, w in levels),
                                                K1_SHAPE["M"], K1_SHAPE["D"], K1_SHAPE["P"], 2,
                                                optin, sms)
        k1[plan.kernel] += 6 * 2
        k7[seminf_cuda.launch_plan(frames, NUM_QUERIES, 2, s // 4, s // 4, SIZE, SIZE).kernel] += 2
    return {"k1": k1, "k7": k7}


def phase_tta(model, smi: str) -> dict:
    """Test-time augmentation through the evaluation entry point, as a user
    runs it: `pred --config-file avs_s4/Test_COMBO_R50_bs8_90k.yaml --save-vis
    TEST.AUG.ENABLED True` with the model's reference `.pth`, over a
    synthetic S4 test split of TTA_VIDEOS videos at batch EVAL_BATCH, bf16
    (TEST.BF16 auto), scales TTA_SCALES with flip: finite metrics in [0, 1];
    K1 and K7 launches by plan, each batch as the plan functions give them
    (`tta_plans_per_batch`); one vis PNG per frame holding the argmax of the
    prediction scored; no import of jax, flax, yaml, cv2, tensorflow or the
    JAX package. Then, on one batch: TTA at [224] without flip equals
    `make_eval_step` bit for bit; bf16 TTA against fp32 TTA (TF32 off)
    within BF16_TTA_MARGIN of the plain eval step's own bf16 error on the
    batch; and the bf16 TTA step's wall and device time."""
    import tempfile
    from unittest import mock

    from combo_avs_torch import pred
    from combo_avs_torch.data.png import read_png
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.evaluation.visual import binary_color_map
    from combo_avs_torch.train import evaluate as evaluate_mod
    from combo_avs_torch.train.checkpoint import save_reference_checkpoint
    from combo_avs_torch.train.train_step import make_eval_step, make_tta_eval_step

    dev = next(model.parameters()).device
    batches = -(-TTA_VIDEOS // EVAL_BATCH)
    per_batch = tta_plans_per_batch(dev, EVAL_BATCH * T)
    timings_, dumped = [], []
    real_vis = evaluate_mod.save_prediction_vis

    def recording_vis(vis_dir, video, p):
        dumped.append((video, p.copy()))
        real_vis(vis_dir, video, p)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_s4(tmp, 0, 0, size=SIZE, n_test=TTA_VIDEOS)
        ckpt = os.path.join(tmp, "model_best.pth")
        save_reference_checkpoint(model, ckpt)
        log(f"[tta] synthetic S4 test tree: {TTA_VIDEOS} videos x {T} frames x {SIZE}^2 and the "
            f".pth in {time.perf_counter() - t0:.1f} s")
        out_dir = os.path.join(tmp, "out")
        with mock.patch.object(evaluate_mod, "evaluate", timed_evaluate(timings_)), \
                mock.patch.object(evaluate_mod, "save_prediction_vis", recording_vis):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = pred.main(["--datasets-root", tmp, "--checkpoint", ckpt, "--config-file",
                             TTA_CONFIG, "--batch-size", str(EVAL_BATCH), "--output-dir",
                             out_dir, "--save-vis", "TEST.AUG.ENABLED", "True"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_imports("[tta] pred.main")
        counts, plans = read_counts(), _plans()
        want = {k: {"k1": 36 * batches, "k7": 6 * batches}.get(k, 0) for k in counts}
        want_plans = {k: {kn: c * batches for kn, c in v.items()} for k, v in per_batch.items()}
        if counts != want or {k: plans[k] for k in want_plans} != want_plans:
            raise AssertionError(f"[tta] launches {counts} by plan {plans}, expected {want} by "
                                 f"plan {want_plans}")
        m, (tm,) = res["sem_seg"], timings_
        scored = (tm["dataset"], tm["bf16"], tm["evaluator"])
        if scored != ("avss4_sem_seg_test", True, "SemSegEvaluator"):
            raise AssertionError(f"[tta] pred scored {scored}, expected avss4_sem_seg_test in "
                                 "bf16 with the S4 evaluator")
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()) or \
                tm["videos"] != TTA_VIDEOS:
            raise AssertionError(f"[tta] metrics {m} over {tm['videos']} videos")
        vis = os.path.join(out_dir, "vis", "avss4_sem_seg_test")
        names = sorted(f"{v}_{t}.png" for v, p in dumped for t in range(p.shape[0]))
        if len(dumped) != TTA_VIDEOS or sorted(os.listdir(vis)) != names:
            raise AssertionError(f"[tta] {len(dumped)} predictions dumped, {vis} holds "
                                 f"{sorted(os.listdir(vis))}")
        palette = binary_color_map()
        for video, p in dumped:
            for t in range(p.shape[0]):
                if not np.array_equal(read_png(os.path.join(vis, f"{video}_{t}.png")),
                                      palette[p[t].argmax(0)]):
                    raise AssertionError(f"[tta] {video}_{t}.png is not the argmax of its "
                                         "prediction")
    log(f"[tta] pred --save-vis TEST.AUG.ENABLED True: {tm['dataset']} in bf16, scales "
        f"{list(TTA_SCALES)} with flip: mIoU {m['mIoU']:.4f}, f_score {m['f_score']:.4f}; "
        f"{tm['videos']} videos, {tm['frames']} frames in {tm['total_s']:.3f} s (data "
        f"{tm['data_s']:.3f}, compute {tm['compute_s']:.3f}, eval {tm['eval_s']:.3f}): "
        f"{tm['videos'] / tm['total_s']:.2f} videos/s; pred.main {wall:.1f} s wall; launches "
        f"{counts} by plan K1 {plans['k1']}, K7 {plans['k7']} (a batch: {per_batch}); "
        f"{len(names)} vis PNGs, each the argmax of its prediction, on {smi}")

    rng = np.random.RandomState(SEED + 7)
    batch = dict(_batch(rng, dev), vid_temporal_mask=torch.ones((B, T), device=dev))
    plain = make_eval_step(model, out_size=(SIZE, SIZE), bf16=True)(batch)
    one = make_tta_eval_step(model, [SIZE], False, (SIZE, SIZE), bf16=True)(batch)
    if not torch.equal(one, plain):
        raise AssertionError(f"[tta] TTA at [{SIZE}] without flip differs from make_eval_step "
                             f"by {float((one - plain).abs().max()):.3e}")
    step16 = make_tta_eval_step(model, TTA_SCALES, True, (SIZE, SIZE), bf16=True)
    with tf32_off():
        fp32 = make_tta_eval_step(model, TTA_SCALES, True, (SIZE, SIZE))(batch)
        plain32 = make_eval_step(model, out_size=(SIZE, SIZE))(batch)
    bf16 = step16(batch)

    def rel(a, b):  # max |a - b| over max |b|
        return float((a - b).abs().max() / b.abs().max())

    err, err_plain = rel(bf16, fp32), rel(plain, plain32)
    if not np.isfinite(err) or err > BF16_TTA_MARGIN * err_plain:
        raise AssertionError(f"[tta] bf16 TTA against fp32: {err:.3e} of max |fp32|, above "
                             f"{BF16_TTA_MARGIN} x the plain step's {err_plain:.3e}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step16(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    prof = profile_window("tta step bf16", lambda: step16(batch), wall_ms)
    log(f"[tta] on one batch [{B}x{T}x{SIZE}^2]: TTA at [{SIZE}] without flip equals "
        f"make_eval_step bit for bit; bf16 against fp32 (TF32 off), max abs over max |fp32|: "
        f"TTA {err:.3e}, the plain step {err_plain:.3e} (TTA's held to {BF16_TTA_MARGIN} x); "
        f"the bf16 TTA step {wall_ms:.2f} ms wall (median of 3), "
        f"{prof['device_ms']:.2f} ms device on {smi}")
    return {"metrics": m, "timing": tm, "launches": counts, "plans": plans,
            "plans_per_batch": per_batch, "wall_s": wall, "bf16_vs_fp32_rel": err,
            "plain_bf16_vs_fp32_rel": err_plain,
            "step_wall_ms": wall_ms, "step_device_ms": prof["device_ms"],
            "step_busy_share": prof["busy_share"]}


def phase_train_fallback(model) -> dict:
    """One full-width training step at FALLBACK_POINTS points: the
    criterion's uncertain-point selection takes top-k and K6 once per decoder
    output; the losses must be finite."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict
    from combo_avs_torch.losses.matcher import HungarianMatcher
    from combo_avs_torch.train.optim import Optimizer
    from combo_avs_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device
    crit = SetCriterion(matcher=HungarianMatcher(num_points=FALLBACK_POINTS),
                        num_points=FALLBACK_POINTS)
    step = make_train_step(model, crit, build_weight_dict(), Optimizer(model),
                           torch.Generator(device=dev).manual_seed(SEED + 4))
    batch = train_batch(TRAIN_B, SIZE, dev, seed=SEED + 4)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    m = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    if counts["k6"] != DEC_OUTPUTS or not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"[train-k6] launches {counts} (K6 expected {DEC_OUTPUTS}), "
                             f"total_loss {m['total_loss']}")
    log(f"[train-k6] one step of [{TRAIN_B}x{T}x{SIZE}^2] at {FALLBACK_POINTS} points: "
        f"{dt:.3f} s, total_loss {m['total_loss']:.6f}, launches {counts}")
    return {"launches": counts, "total_loss": m["total_loss"], "s": dt}


def phase_train(model, smi: str, tag: str = "train", profile: bool = False) -> dict:
    """make_train_step at full width: 1 warm-up and TRAIN_STEPS timed steps;
    with `profile`, a profiler window over one more step, after the checks."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict
    from combo_avs_torch.ops import point_sample_cuda
    from combo_avs_torch.train.optim import Optimizer
    from combo_avs_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device
    wd = build_weight_dict()
    step = make_train_step(model, SetCriterion(), wd, Optimizer(model),
                           torch.Generator(device=dev).manual_seed(SEED))
    batch = train_batch(TRAIN_B, SIZE, dev, seed=SEED)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for i in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        log(f"[{tag}] step {i}{' (warm-up)' if i == 0 else ''}: {times[-1]:.4f} s, "
            f"total_loss {metrics[-1]['total_loss']:.6f}, loss_ce {metrics[-1]['loss_ce']:.6f}, "
            f"loss_mask {metrics[-1]['loss_mask']:.6f}, loss_dice {metrics[-1]['loss_dice']:.6f}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + TRAIN_STEPS
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"[{tag}] launches {counts} in {steps} steps, expected {want}")
    dimg_plans = dict(point_sample_cuda.dimg_plan_launches)
    if dimg_plans != {"global": 0, "staged": want["k4_dimg"]}:
        raise AssertionError(f"[{tag}] K4 dimg launches by plan {dimg_plans}: every one should "
                             "take the staged plan")
    for m in metrics:
        if set(m) != {"total_loss", *wd} or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"[{tag}] losses not finite or misnamed: {m}")
    after = model.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    buffers = {n for n, _ in model.named_buffers()}
    frozen = {k for k in before if k.startswith("audio_backbone.")} | buffers
    decoder = {k for k in before if k.startswith("sem_seg_head.predictor.")}
    if changed & frozen:
        raise AssertionError(f"[{tag}] frozen tensors changed: {sorted(changed & frozen)[:5]}")
    if not decoder <= changed:
        raise AssertionError(f"[{tag}] decoder tensors unchanged: {sorted(decoder - changed)[:5]}")
    for tower in ("backbone.", "pre_sam_backbone."):
        if not any(k.startswith(tower) for k in changed):
            raise AssertionError(f"[{tag}] no tensor of the {tower[:-1]} tower changed")
    med = float(np.median(times[1:]))
    log(f"[{tag}] {TRAIN_STEPS} steps of [{TRAIN_B}x{T}x{SIZE}^2], K={TRAIN_K}, fp32: median "
        f"{med:.4f} s/step ({TRAIN_N / med:.1f} frames/s), warm-up {times[0]:.4f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB on {smi} (TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}); "
        f"{len(changed)} of {len(before)} tensors changed, frozen ones unchanged; launches "
        f"{counts} in {steps} steps (K4 dimg by plan {dimg_plans})")
    out = {"launches": counts, "s_per_step": med, "peak_bytes": peak, "times": times,
           "dimg_plans": dimg_plans}
    if profile:
        out["profile"] = profile_window(tag, lambda: step(batch), med * 1e3, calls=1)
    return out


def _plans() -> dict:
    """The per-plan launch counts of K1, K2, K4 dimg and K7."""
    from combo_avs_torch.ops import deform_attn_cuda, point_sample_cuda, seminf_cuda

    return {"k1": dict(deform_attn_cuda.fwd_plan_launches),
            "k2": dict(deform_attn_cuda.bwd_plan_launches),
            "k4_dimg": dict(point_sample_cuda.dimg_plan_launches),
            "k7": dict(seminf_cuda.plan_launches)}


def phase_train_entry(smi: str, bare_s_per_step: float, cfg_file: str, tag: str = "train-entry",
                      keep_dir: str = "", resume: bool = True) -> dict:
    """A training entry point at full width: `train_net.main` on a shipped
    S4 config over a synthetic tree (ENTRY_TRAIN_VIDEOS train videos,
    batches of 8; ENTRY_VAL_VIDEOS val videos), ENTRY_ITERS iterations with
    an evaluation and a step checkpoint every ENTRY_PERIOD, then, with
    `resume`, `--resume --max-iter ENTRY_RESUME_TO`. Every iteration is logged; the resumed run
    logs the iterations after ENTRY_ITERS only; the losses are finite; the step checkpoints and a
    `model_best.pth` that loads into the config's model are written, and
    metrics.json holds the mIoU; each kernel launches as often as the steps
    and the eval batches imply, through the plans the training phase takes
    (K1 staged, K2 level_slice, K4 dimg staged, K7 patch); and the run
    imports none of jax, flax, yaml, cv2, tensorflow or the JAX package.
    With `keep_dir`, the output directory (model_best.pth) is kept there."""
    import shutil
    import tempfile

    from combo_avs_torch import train_net
    from combo_avs_torch.config import setup_cfg
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.models.meta_arch import build_model
    from combo_avs_torch.train.checkpoint import load_reference_checkpoint

    train_videos, val_videos = ENTRY_TRAIN_VIDEOS, ENTRY_VAL_VIDEOS
    iters, period = ENTRY_ITERS, ENTRY_PERIOD
    resume_to = ENTRY_RESUME_TO if resume else iters
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_s4(tmp, train_videos, val_videos, size=SIZE)
        log(f"[{tag}] synthetic S4 tree: {train_videos} train and {val_videos} "
            f"val videos x {T} frames x {SIZE}^2 in {time.perf_counter() - t0:.1f} s")
        out_dir = os.path.join(tmp, "out")
        common = ["--config-file", cfg_file, "--datasets-root", tmp, "--log-every", "1"]
        opts = ["OUTPUT_DIR", out_dir, "SOLVER.MAX_ITER", str(iters), "TEST.EVAL_PERIOD",
                str(period), "SOLVER.CHECKPOINT_PERIOD", str(period)]
        runs = (("first", common + opts, range(1, iters + 1), iters // period),
                ("resumed", common + ["--resume", "--max-iter", str(resume_to)] + opts,
                 range(iters + 1, resume_to + 1), 0))[:2 if resume else 1]
        rows_seen = 0
        for name, argv, want_iters, evals in runs:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            trainer = train_net.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_imports(f"[{tag}] {name}: train_net.main")
            counts, plans = read_counts(), _plans()
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f][rows_seen:]
            rows_seen += len(rows)
            steps = [r for r in rows if "total_loss" in r]
            if [r["iter"] for r in steps] != list(want_iters):
                raise AssertionError(f"[{tag}] {name}: logged iterations "
                                     f"{[r['iter'] for r in steps]}, expected {list(want_iters)}")
            if not all(np.isfinite(r["total_loss"]) for r in steps):
                raise AssertionError(f"[{tag}] {name}: losses {steps}")
            n, batches = len(steps), evals * val_videos
            want = {k: v * n for k, v in TRAIN_LAUNCHES.items()}
            want["k1"] += 6 * batches
            want["k7"] += batches
            want_plans = {"k1": {"staged": want["k1"], "grouped": 0, "global": 0},
                          "k2": {"level_slice": want["k2"], "global": 0},
                          "k4_dimg": {"staged": want["k4_dimg"], "global": 0},
                          "k7": {"patch": want["k7"], "pixel": 0}}
            if counts != want or plans != want_plans:
                raise AssertionError(f"[{tag}] {name}: launches {counts} by plan {plans}, "
                                     f"expected {want} by plan {want_plans} ({n} steps, "
                                     f"{batches} eval batches)")
            evals_done = [r for r in rows if "mIoU" in r]
            if len(evals_done) != evals:
                raise AssertionError(f"[{tag}] {name}: {len(evals_done)} evaluations, "
                                     f"expected {evals}")
            for r in steps:
                log(f"[{tag}] {name}: iter {r['iter']}: total_loss {r['total_loss']:.6f}, "
                    f"{r['s_per_iter']:.4f} s/iter, data_time {r['data_time']:.4f} s/iter "
                    f"(bare step {bare_s_per_step:.4f} s/step) on {smi}")
            timing = trainer.eval_timing.get(trainer.cfg.DATASETS.TEST[0])
            for r in evals_done:
                log(f"[{tag}] {name}: eval @ {r['iter']}: mIoU {r['mIoU']:.4f}, "
                    f"f_score {r['f_score']:.4f}")
            if timing:
                log(f"[{tag}] {name}: last eval {timing['videos']} videos in "
                    f"{timing['total_s']:.3f} s (data {timing['data_s']:.3f}, compute "
                    f"{timing['compute_s']:.3f}, eval {timing['eval_s']:.3f}): "
                    f"{timing['videos'] / timing['total_s']:.2f} videos/s on {smi}")
            log(f"[{tag}] {name}: {wall:.1f} s wall; launches {counts} by plan {plans}")
            out[name] = {"launches": counts, "plans": plans, "rows": steps, "evals": evals_done,
                         "eval_timing": timing, "wall_s": wall}
            del trainer
            torch.cuda.empty_cache()
        names = set(os.listdir(out_dir))
        need = {f"step_{period}", f"step_{iters}", f"step_{resume_to}", "model_best.pth",
                "metrics.json"}
        if not need <= names:
            raise AssertionError(f"[{tag}] {sorted(need - names)} missing in {sorted(names)}")
        best = build_model(setup_cfg(cfg_file))
        load_reference_checkpoint(best, os.path.join(out_dir, "model_best.pth"))
        del best
        with open(os.path.join(out_dir, "metrics.json")) as f:
            if not any("sem_seg/mIoU" in json.loads(line) for line in f):
                raise AssertionError(f"[{tag}] metrics.json holds no sem_seg/mIoU row")
        if keep_dir:
            shutil.copy(os.path.join(out_dir, "model_best.pth"), keep_dir)
    torch.cuda.empty_cache()
    if not resume:
        out["resumed"] = {"rows": [], "launches": dict.fromkeys(out["first"]["launches"], 0)}
    steps = out["first"]["rows"] + out["resumed"]["rows"]
    s_iter = [r["s_per_iter"] for r in steps[1:]]
    d_iter = [r["data_time"] for r in steps[1:]]
    log(f"[{tag}] loop after the first iteration: median {np.median(s_iter):.4f} s/iter, "
        f"data_time median {np.median(d_iter):.4f} s/iter, against the bare step's "
        f"{bare_s_per_step:.4f} s/step; {sorted(names)} written; model_best.pth loads; "
        f"on {smi}")
    out["launches"] = {k: out["first"]["launches"][k] + out["resumed"]["launches"][k]
                       for k in out["first"]["launches"]}
    out["s_per_iter_median"], out["data_time_median"] = float(np.median(s_iter)), \
        float(np.median(d_iter))
    return out


NOT_IMPORTED = ("jax", "flax", "yaml", "cv2", "combo_avs_tpu", "tensorflow")


def check_imports(what: str) -> None:
    """Raise if the process has imported any of NOT_IMPORTED."""
    loaded = [m for m in NOT_IMPORTED if m in sys.modules]
    if loaded:
        raise AssertionError(f"{what} imported {loaded}")


def timed_evaluate(timings: list):
    """A stand-in for `train/evaluate.py::evaluate` that runs it and keeps
    each call's split, precision, evaluator and timing in `timings`."""
    from combo_avs_torch.train import evaluate as evaluate_mod

    real = evaluate_mod.evaluate

    def timed(model, dataset_name, **kw):
        res, tm = real(model, dataset_name, **kw)
        timings.append(dict(tm, dataset=dataset_name, bf16=kw.get("bf16"),
                            evaluator=type(kw.get("evaluator")).__name__))
        return res, tm

    return timed


def phase_pred_ms3(smi: str, checkpoint: str) -> dict:
    """The MS3 evaluation entry point at full width, as a user runs it: `pred
    --config-file avs_ms3/Test_COMBO_PVTV2B5_bs8_20k.yaml` with `checkpoint`
    and no `--dataset` or `--bf16`, over a synthetic MS3 test tree of
    PRED_VIDEOS videos at batch EVAL_BATCH: it must score the config's
    avsms3_sem_seg_test in bf16 (TEST.BF16 "auto" on the card) with the
    MS3 evaluator; metrics in [0, 1], K1 six times and K7 once per batch
    (patch), its timers, and no import of jax, flax, yaml, cv2, tensorflow
    or the JAX package."""
    import tempfile
    from unittest import mock

    from combo_avs_torch import pred
    from combo_avs_torch.data.synth import make_ms3
    from combo_avs_torch.train import evaluate as evaluate_mod

    batches = -(-PRED_VIDEOS // EVAL_BATCH)
    timings = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_ms3(tmp, 0, 0, size=SIZE, n_test=PRED_VIDEOS)
        log(f"[pred-ms3] synthetic MS3 test tree: {PRED_VIDEOS} videos x {T} frames x {SIZE}^2 "
            f"in {time.perf_counter() - t0:.1f} s")
        with mock.patch.object(evaluate_mod, "evaluate", timed_evaluate(timings)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = pred.main(["--datasets-root", tmp, "--checkpoint", checkpoint, "--config-file",
                             MS3_TEST_CONFIG, "--batch-size", str(EVAL_BATCH)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    check_imports("[pred-ms3] pred.main")
    counts, plans = read_counts(), _plans()
    want = {k: {"k1": 6 * batches, "k7": batches}.get(k, 0) for k in counts}
    if counts != want or plans["k7"] != {"patch": batches, "pixel": 0}:
        raise AssertionError(f"[pred-ms3] launches {counts} by plan {plans}, expected {want}")
    m, (tm,) = res["sem_seg"], timings
    scored = (tm["dataset"], tm["bf16"], tm["evaluator"])
    if scored != ("avsms3_sem_seg_test", True, "SemSegEvaluator"):
        raise AssertionError(f"[pred-ms3] pred scored {scored}, expected the config's "
                             "avsms3_sem_seg_test in bf16 with the MS3 evaluator")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()) or tm["videos"] != \
            PRED_VIDEOS:
        raise AssertionError(f"[pred-ms3] metrics {m} over {tm['videos']} videos")
    log(f"[pred-ms3] {tm['dataset']} (the config's DATASETS.TEST, no --dataset), bf16 "
        f"(TEST.BF16 auto): mIoU {m['mIoU']:.4f}, f_score {m['f_score']:.4f}; {tm['videos']} "
        f"videos, {tm['frames']} frames in {tm['total_s']:.3f} s (data {tm['data_s']:.3f}, "
        f"compute {tm['compute_s']:.3f}, eval {tm['eval_s']:.3f}): "
        f"{tm['videos'] / tm['total_s']:.2f} videos/s; pred.main {wall:.1f} s wall; launches "
        f"{counts} on {smi}")
    return {"metrics": m, "timing": tm, "launches": counts, "wall_s": wall}


def cpu_twin(model, build):
    """`build(device)` with `model`'s weights on the CPU: built on the meta
    device and given storage on the CPU, so that no initializer runs before
    the weights are copied in."""
    cpu = build("meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    return cpu


class tf32_off:
    """TF32 off for both matmuls and cuDNN inside the block; the flags as
    they were after it (the other phases run under torch's defaults)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class SharedAttnMask:
    """The masked decoder's attention masks for a card-vs-CPU comparison.
    Each layer's mask is sigmoid(m) < 0.5 for the downsampled mask logits m,
    and float32 rounding can put an m that lies near 0 on either side, so a
    near-tie blocks a position on one side and not on the other (the weights
    come from the nondeterministic training steps, so such a tie shows up in
    some runs and not others). While active, the CPU pass records each mask
    and the card pass takes the CPU's, as `SharedMatching` does for the
    matching.

    The card's own mask is still computed and held to what a tie cannot
    break: with delta the largest |m_card - m_cpu| of the call, a position
    may be blocked on one side only where |m_cpu| <= delta. A near-tie
    passes; a wrong mask fails."""

    def __init__(self, tag: str, cpu, card):
        self.tag, self.models = tag, (cpu, card)
        self.recorded, self.replay = [], None
        self.positions = self.flipped = 0
        self.tightest = 0.0  # the largest |m_cpu| at a flipped position

    def __enter__(self):
        for m in self.models:
            heads = m.sem_seg_head.predictor._prediction_heads
            m.sem_seg_head.predictor._prediction_heads = (
                lambda *a, heads=heads: self._heads(heads, *a))
        return self

    def __exit__(self, *exc):
        for m in self.models:
            del m.sem_seg_head.predictor._prediction_heads

    def card_pass(self):
        self.replay = list(self.recorded)

    def _heads(self, heads, output, mask_features, target_size):
        import torch.nn.functional as F

        logits, masks, attn_mask = heads(output, mask_features, target_size)
        small = F.interpolate(masks.detach(), size=target_size, mode="bilinear",
                              align_corners=False, antialias=False).reshape(attn_mask.shape)
        if self.replay is None:
            self.recorded.append((small.float().cpu(), attn_mask.cpu()))
            return logits, masks, attn_mask
        small_cpu, want = self.replay.pop(0)
        delta = float((small.float().cpu() - small_cpu).abs().max())
        flips = attn_mask.cpu() != want
        self.positions += want.numel()
        self.flipped += int(flips.sum())
        if bool(flips.any()):
            worst = float(small_cpu[flips].abs().max())
            if worst > delta:
                raise AssertionError(f"[{self.tag}] the card's attention mask differs from the "
                                     f"CPU's where |m_cpu| = {worst:.3e}, beyond the calls' "
                                     f"largest |m_card - m_cpu| {delta:.3e}")
            self.tightest = max(self.tightest, worst)
        return logits, masks, want.to(attn_mask.device)

    def report(self) -> str:
        return (f"the card's own attention masks blocked {self.flipped} of {self.positions} "
                f"positions otherwise than the CPU's, each a near-tie (largest |m_cpu| at "
                f"one {self.tightest:.3e}); both sides took the CPU's masks")


def phase_card_vs_cpu(model, cpu, tag: str = "card-vs-cpu", frames: int = 1) -> dict:
    """The inference forward on 1 video x `frames` x 224^2, card against the
    CPU twin `cpu` (same weights), TF32 off, the CPU's attention masks on
    both sides (`SharedAttnMask`)."""
    rng = np.random.RandomState(SEED + 1)
    images = rng.randint(0, 256, (1, frames, SIZE, SIZE, 3)).astype(np.float32)
    mel = rng.randn(1, frames, 96, 64).astype(np.float32)
    pre = rng.randint(0, 256, (1, frames, SIZE, SIZE, 3)).astype(np.float32)
    cpu.eval()
    model.eval()
    outs = {}
    with torch.inference_mode(), tf32_off(), SharedAttnMask(tag, cpu, model) as shared:
        for name, m in (("cpu", cpu), ("gpu", model)):
            if name == "gpu":
                shared.card_pass()
            d = next(m.parameters()).device
            o = m(*(torch.from_numpy(a).to(d) for a in (images, mel, pre)))
            outs[name] = {k: o[k].float().cpu().numpy() for k in ("pred_logits", "pred_masks")}
    log(f"[{tag}] {shared.report()}")
    errs = {"attn_mask_flips": shared.flipped}
    for k in ("pred_logits", "pred_masks"):
        a, b = outs["gpu"][k], outs["cpu"][k]
        errs[k] = float(np.abs(a - b).max())
        log(f"[{tag}] {k} {a.shape}: max_abs_err {errs[k]:.3e} "
            f"(max|cpu| {float(np.abs(b).max()):.3f}; atol {SLICE_ATOL}, rtol {SLICE_RTOL}, TF32 off)")
        np.testing.assert_allclose(a, b, atol=SLICE_ATOL, rtol=SLICE_RTOL)
    return errs


class SharedMatching:
    """The criterion's matcher for the card-vs-CPU comparison. The CPU pass
    records its cost matrices and assignments and the card pass takes the
    CPU's assignment, so that a near-tie between two queries' matching
    costs, which float32 rounding can break either way, cannot swap the mask
    a loss is taken on (the weights come from the nondeterministic training
    steps, so such a tie shows up in some runs and not others).

    The card's own matcher still runs on the card pass, and `check` holds
    its assignment to what a tie cannot break: per frame, with delta the
    largest |C_card - C_cpu| over the frame's valid slots and K_v their
    number, an assignment optimal for C_card costs at most 2 K_v delta more
    under C_cpu than the CPU's optimum, plus the solver's float32 rounding.
    A near-tie passes; a wrong assignment fails."""

    def __init__(self, matcher):
        self.matcher, self.recorded, self.replay = matcher, [], None
        self.slots = self.differ = self.frames = 0
        self.tightest = None  # (excess over the CPU optimum, its bound, delta)

    def __getattr__(self, name):  # num_points, for the draws
        return getattr(self.matcher, name)

    def match_layers(self, layers):
        """The criterion's call: each decoder output through `__call__`."""
        return [self(*args) for args in layers]

    def __call__(self, *args):
        assign = self.matcher(*args)
        cost = self.matcher.solved_costs([args])[0].double().cpu()  # the cost the matcher solves
        if self.replay is None:
            self.recorded.append((cost, assign))
            return assign
        cost_cpu, want = self.replay.pop(0)
        self.check(cost_cpu, want.cpu(), cost, assign.cpu(), args[5].cpu())
        want = want.to(assign.device)
        self.slots += want.numel()
        self.differ += int((want != assign).sum())
        return want

    def check(self, cost_cpu, assign_cpu, cost_card, assign_card, valid):
        """cost_* [N, Q, K] float64, assign_* [N, K] (-1 on an invalid
        slot), valid [N, K]; raises where the card's assignment reuses a
        query or costs more under C_cpu than the bound allows.

        The rounding term is 1e-5 x max(1, |optimum|), or the float32
        rounding bound of the card solver's sums where that is larger: the
        solver (`ops/lsap.py`) compares float32 totals of K terms, BIG_COST
        for each invalid slot included, and a sum of K terms is off by at
        most (K - 1) 2^-24 times the sum of their magnitudes, for each of
        the two totals it compares (its choice and the CPU's)."""
        from combo_avs_torch.losses.matcher import BIG_COST

        N, Q, K = cost_cpu.shape
        for n in range(N):
            ks = valid[n].nonzero().flatten()
            if not len(ks):
                continue
            q_card, q_cpu = assign_card[n, ks], assign_cpu[n, ks]
            if (len(set(q_card.tolist())) != len(ks) or int(q_card.min()) < 0
                    or int(q_card.max()) >= Q):
                raise AssertionError(f"[matching] the card's matcher assigned queries "
                                     f"{q_card.tolist()} to the {len(ks)} valid slots of a frame")
            delta = float((cost_card[n][:, ks] - cost_cpu[n][:, ks]).abs().max())
            optimum = float(cost_cpu[n, q_cpu, ks].sum())
            got = float(cost_cpu[n, q_card, ks].sum())
            big = BIG_COST * (K - len(ks))  # the invalid slots' share of each solver total
            magnitude = (float(cost_card[n, q_card, ks].abs().sum())
                         + float(cost_card[n, q_cpu, ks].abs().sum()) + 2 * big)
            rounding = max(1e-5 * max(1.0, abs(optimum)), (K - 1) * 2.0**-24 * magnitude)
            allowed = 2 * len(ks) * delta + rounding
            if got - optimum > allowed:
                raise AssertionError(f"[matching] the card's matching {q_card.tolist()} "
                                     f"costs {got:.6f} under the CPU's costs, the CPU optimum "
                                     f"{q_cpu.tolist()} {optimum:.6f}: {got - optimum:.3e} above "
                                     f"it, more than 2 K_v delta + rounding = {allowed:.3e} "
                                     f"(delta {delta:.3e})")
            self.frames += 1
            if self.tightest is None or (got - optimum) / allowed > (
                    self.tightest[0] / self.tightest[1]):
                self.tightest = (got - optimum, allowed, delta)


def phase_train_card_vs_cpu(model, cpu, tag: str = "train-card-vs-cpu") -> dict:
    """The training losses and every parameter's gradient, card against the
    CPU twin `cpu`: full width, 1 video x 5 frames x 128^2, TF32 off,
    dropout and drop path off (eval mode), the same weights, the same
    injected draws, the CPU's matching (`SharedMatching`) and attention masks
    (`SharedAttnMask`), exact top-k on both sides (the CPU always takes
    it)."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict, total_loss
    from combo_avs_torch.train.train_step import compute_losses

    dev = next(model.parameters()).device
    batch = {k: v.cpu() for k, v in train_batch(1, TRAIN_VS_CPU_SIZE, dev, seed=SEED + 2).items()}
    crit = SetCriterion(exact_topk=True)
    matching = crit.matcher = SharedMatching(crit.matcher)
    wd = build_weight_dict()
    g = torch.Generator().manual_seed(SEED + 3)
    draws = [crit.draw(g, T, TRAIN_K) for _ in range(DEC_OUTPUTS)]
    res = {}
    shared = SharedAttnMask(tag, cpu, model)
    for name, m in (("cpu", cpu), ("gpu", model)):
        d = next(m.parameters()).device
        if name == "gpu":
            matching.replay = list(matching.recorded)
            shared.card_pass()
        m.eval()
        m.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        with tf32_off(), shared:
            losses = compute_losses(m, crit, batch, torch.Generator(device=d),
                                    draws=[tuple(t.to(d) for t in dr) for dr in draws])
            total_loss(losses, wd).backward()
        grads = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()
                 if p.grad is not None}
        res[name] = ({k: float(v.detach()) for k, v in losses.items()}, grads)
        log(f"[{tag}] {name}: losses and gradients in {time.perf_counter() - t0:.1f} s")
    model.zero_grad(set_to_none=True)
    excess, allowed, delta = matching.tightest
    log(f"[{tag}] the card's matcher chose another query for {matching.differ} of "
        f"{matching.slots} slots (a near-tie in the cost); both sides took the CPU's matching. "
        f"Its own assignment in each of {matching.frames} frames: distinct queries, cost under "
        f"the CPU's costs within the bound; tightest frame {excess:.3e} above the CPU optimum "
        f"against a bound of {allowed:.3e} (delta {delta:.3e}); {shared.report()}")
    (lc, gc), (lg, gg) = res["cpu"], res["gpu"]
    if set(gc) != set(gg) or set(lc) != set(lg):
        raise AssertionError(f"[{tag}] different losses or gradient sets")
    loss_err = {k: abs(lg[k] - lc[k]) / max(1.0, abs(lc[k])) for k in lc}
    worst = max(loss_err, key=loss_err.get)
    norm_all = float(torch.sqrt(sum((gc[n] ** 2).sum() for n in gc)))
    rl2 = {n: float((gg[n] - gc[n]).norm()) / max(float(gg[n].norm()), float(gc[n].norm()),
                                                  GRAD_FLOOR * norm_all)
           for n in gc}
    all_rl2 = float(torch.sqrt(sum(((gg[n] - gc[n]) ** 2).sum() for n in gc))) / norm_all
    worst_leaf = max(rl2, key=rl2.get)
    median = float(np.median(list(rl2.values())))
    log(f"[{tag}] {len(lc)} losses, worst {worst} rel err {loss_err[worst]:.3e} "
        f"(tol {LOSS_RTOL_CPU}); {len(gc)} gradient leaves: worst {worst_leaf} rel-L2 "
        f"{rl2[worst_leaf]:.3e} (tol {GRAD_RL2_LEAF}), median {median:.3e} (tol "
        f"{GRAD_RL2_MEDIAN}), whole gradient {all_rl2:.3e} (tol {GRAD_RL2_ALL}); TF32 off")
    if (loss_err[worst] > LOSS_RTOL_CPU or rl2[worst_leaf] > GRAD_RL2_LEAF
            or median > GRAD_RL2_MEDIAN or all_rl2 > GRAD_RL2_ALL):
        raise AssertionError(f"[{tag}] card and CPU disagree beyond the tolerances")
    return {"loss_rel_err": loss_err[worst], "grad_rl2_leaf": rl2[worst_leaf],
            "grad_rl2_median": median, "grad_rl2_all": all_rl2}


TIMING_KEYS = ("ms", "device_source", "call_ms", "host_us", "plain_ms", "library_ms",
               "library_source", "library_call_ms", "library_host_us")


def kernel_entry(name, source, replaces, launches, numbers, **extra) -> dict:
    """One kernel of the `kernels` line: `ms` is its device ms, `call_ms` one
    eager call's, `plain_ms` the plain version's call ms, `library_ms` the
    library call's device ms (null where no single call computes the function)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            **{k: numbers[k] for k in keys}, "library_ms": numbers.get("library_ms"),
            **{k: numbers[k] for k in TIMING_KEYS if k in numbers and k not in keys}, **extra}


def rank_against_library(rows) -> list:
    """Each (name, timings) with a library call, slowest against it first, by
    device ms; prints the ranking."""
    ranked = sorted(((name, t["ms"], t["library_ms"], t["ms"] / t["library_ms"])
                     for name, t in rows if t.get("library_ms")), key=lambda r: -r[3])
    for name, ms, lib, ratio in ranked:
        log(f"[rank] {name}: {ms:.4f} ms device against the library's {lib:.4f} ms: "
            f"{ratio:.2f}x ({'slower' if ratio > 1 else 'no slower'})")
    return ranked


def profile_window(tag: str, fn, wall_ms: float, calls: int = 2) -> dict:
    """The device's view of `calls` more calls of `fn`, under torch.profiler
    (CUDA activity only): kernel ms per call, that share of `wall_ms` (the
    unprofiled call's wall, measured before), device events per call, and
    the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation and "Memcpy" not in e.name]
    dev_ms = sum(e.device_time for e in events) / 1e3 / calls
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] profiler, {calls} calls: device kernel time {dev_ms:.2f} ms a call, "
        f"{dev_ms / wall_ms:.3f} of the unprofiled call's {wall_ms:.2f} ms wall; "
        f"{len(events) / calls:.0f} kernels a call; most device time: "
        + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top))
    return {"device_ms": dev_ms, "busy_share": dev_ms / wall_ms, "kernels": len(events) / calls,
            "top": top}


def phase_pvt(smi: str, dev: torch.device, walls: dict) -> dict:
    """COMBO-PVTv2-B5 at full depth and width (`build_model` of the shipped
    avs_s4 config, seeded weights): the eval slice (pvt-slice), training
    steps (pvt-train), card against CPU on the trained weights
    (pvt-card-vs-cpu: the eval forward on 1 x 5 x 224^2, losses and
    gradients on 1 x 5 x 128^2), `train_net` with an evaluation and a
    checkpoint (pvt-entry), and `pred` on the MS3 config with
    the model_best.pth it wrote (pred-ms3)."""
    import tempfile

    from combo_avs_torch.config import setup_cfg
    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import build_model

    cfg = setup_cfg(PVT_CONFIGS["s4"])
    t0 = time.perf_counter()
    model = init_weights(build_model(cfg), seed=SEED)  # MODEL.DEVICE "cuda": the card
    if next(model.parameters()).device != dev:
        raise AssertionError("build_model did not build on the card")
    depths = [len(getattr(model.backbone, f"block{i}")) for i in range(1, 5)]
    tower = sum(p.numel() for p in model.backbone.parameters())
    if depths != [3, 6, 40, 3] or not 78e6 < tower < 85e6:
        raise AssertionError(f"[pvt-model] depths {depths}, {tower} parameters a tower")
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    walls["pvt-model"] = time.perf_counter() - t0
    log(f"[pvt-model] build_model({os.path.relpath(PVT_CONFIGS['s4'], REPO)}): {n_params} "
        f"parameters ({tower} a PVTv2-B5 tower, depths {depths}), seeded init on "
        f"{torch.cuda.get_device_name(0)} in {walls['pvt-model']:.1f} s")
    out = {}
    t0 = time.perf_counter()
    out["slice"] = phase_slice(model, smi, tag="pvt-slice", profile=True)
    walls["pvt-slice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = phase_train(model, smi, tag="pvt-train", profile=True)
    walls["pvt-train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = cpu_twin(model, lambda d: build_model(cfg, device=d))
    out["card_vs_cpu"] = phase_card_vs_cpu(model, twin, tag="pvt-card-vs-cpu", frames=T)
    out["train_card_vs_cpu"] = phase_train_card_vs_cpu(model, twin, tag="pvt-train-card-vs-cpu")
    walls["pvt-card-vs-cpu"] = time.perf_counter() - t0
    del model, twin
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as keep:
        t0 = time.perf_counter()
        # no resumed run: the R50 train-entry phase checks resume (cut to pay
        # for the ddp phase)
        out["entry"] = phase_train_entry(smi, out["train"]["s_per_step"], PVT_CONFIGS["s4"],
                                         tag="pvt-entry", keep_dir=keep, resume=False)
        walls["pvt-entry"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["pred_ms3"] = phase_pred_ms3(smi, os.path.join(keep, "model_best.pth"))
        walls["pred-ms3"] = time.perf_counter() - t0
    tr, en = out["train"], out["entry"]
    out["summary"] = {
        "model": {"config": os.path.relpath(PVT_CONFIGS["s4"], REPO), "parameters": n_params,
                  "tower_parameters": tower, "depths": depths},
        "eval_fps": out["slice"]["fps"], "eval_k1_plans": out["slice"]["k1_plans"],
        "eval_profile": out["slice"]["profile"], "train_profile": out["train"]["profile"],
        "eval_k7_plans": out["slice"]["k7_plans"],
        "train": {"s_per_step": tr["s_per_step"], "step_times_s": tr["times"],
                  "max_memory_allocated": tr["peak_bytes"],
                  "launches_per_step": {k: v // (1 + TRAIN_STEPS)
                                        for k, v in tr["launches"].items()},
                  "shape": f"{TRAIN_B}x{T}x{SIZE}^2 K={TRAIN_K} fp32"},
        "card_vs_cpu": out["card_vs_cpu"], "train_card_vs_cpu": out["train_card_vs_cpu"],
        "train_entry": {"s_per_iter_median": en["s_per_iter_median"],
                        "data_time_median": en["data_time_median"],
                        "rows": en["first"]["rows"] + en["resumed"]["rows"],
                        "evals": en["first"]["evals"], "eval_timing": en["first"]["eval_timing"]},
        "pred_ms3": {k: out["pred_ms3"][k] for k in ("metrics", "timing", "wall_s")},
    }
    return out


def avss_batch(b: int, size: int, dev, seed: int) -> dict:
    """A loader-format AVSS training batch of the 10-frame bucket made on
    `dev`: uint8 frames and Maskiges, fp32 log-mel, K = 12 slots of class
    indices (1 to 4 valid a frame, distinct classes of the 71) and bool
    masks, every frame annotated, weighted and heard (v2's flags)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_valid = torch.randint(1, 5, (b, AVSS_T, 1), generator=g, device=dev)
    valid = torch.arange(AVSS_K, device=dev) < n_valid
    labels = torch.argsort(torch.rand((b, AVSS_T, AVSS_CLASSES), generator=g, device=dev),
                           dim=-1)[..., :AVSS_K]
    masks = torch.rand((b, AVSS_T, AVSS_K, size, size), generator=g, device=dev) > 0.7
    return {
        "images": torch.randint(0, 256, (b, AVSS_T, size, size, 3), generator=g, device=dev,
                                dtype=torch.uint8),
        "audio_log_mel": torch.randn((b, AVSS_T, 96, 64), generator=g, device=dev),
        "pre_masks": torch.randint(0, 256, (b, AVSS_T, size, size, 3), generator=g, device=dev,
                                   dtype=torch.uint8),
        "labels": labels, "masks": masks & valid[..., None, None], "valid": valid,
        "gt_temporal_mask": torch.ones((b, AVSS_T), device=dev),
        "vid_temporal_mask": torch.ones((b, AVSS_T), device=dev),
    }


class MatcherClock:
    """Wraps a criterion's matcher and, while `on`, times each of its calls
    (one a step: every decoder output's matching) between two
    synchronizations, and within it the assignment solve
    (`ops/lsap.py::solve_lsap_batch` as the matcher calls it): `walls` and
    `solve_walls`, seconds."""

    def __init__(self, matcher):
        self.matcher, self.on, self.walls, self.solve_walls = matcher, False, [], []

    def __getattr__(self, name):  # num_points, cost_matrix
        return getattr(self.matcher, name)

    def match_layers(self, layers):
        if not self.on:
            return self.matcher.match_layers(layers)
        from unittest import mock

        from combo_avs_torch.losses import matcher as matcher_mod

        solve = matcher_mod.solve_lsap_batch

        def timed_solve(cost):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve(cost)
            torch.cuda.synchronize()
            self.solve_walls.append(time.perf_counter() - t0)
            return out

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(matcher_mod, "solve_lsap_batch", timed_solve):
            out = self.matcher.match_layers(layers)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        return out


def phase_avss_train(smi: str, model, cfg) -> dict:
    """The AVSS AMP step at full width: `make_train_step(amp=True)` on
    AVSS_B videos x AVSS_T frames x 224^2 (K = 12, 71 classes, v2 flags),
    1 warm-up and AVSS_STEPS - 1 timed steps, then one more with the matcher
    timed (synchronized around it): s/step, peak memory, the matcher's wall,
    finite losses, the weights still float32, and the launches per step by
    plan and value type (K1 6, K2 6 bf16 level_slice, K3 40 (K5 0), K4 dimg
    10 staged, K4 dxy 0, K6 0, K7 0, the matcher's cost kernel 10: the AMP
    outputs reach the matcher as float32)."""
    from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict
    from combo_avs_torch.ops import deform_attn_cuda
    from combo_avs_torch.train.optim import build_optimizer
    from combo_avs_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device
    crit, wd = build_criterion(cfg), build_weight_dict(cfg)
    clock = crit.matcher = MatcherClock(crit.matcher)
    step = make_train_step(model, crit, wd, build_optimizer(cfg, model),
                           torch.Generator(device=dev).manual_seed(SEED),
                           amp=cfg.SOLVER.AMP.ENABLED)
    batch = avss_batch(AVSS_B, SIZE, dev, seed=SEED + 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for i in range(AVSS_STEPS + 1):
        clock.on = i == AVSS_STEPS
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        log(f"[avss-train] step {i}{' (warm-up)' if i == 0 else ''}"
            f"{' (matcher timed)' if clock.on else ''}: {times[-1]:.4f} s, total_loss "
            f"{metrics[-1]['total_loss']:.6f}, loss_ce {metrics[-1]['loss_ce']:.6f}, "
            f"loss_mask {metrics[-1]['loss_mask']:.6f}, loss_dice {metrics[-1]['loss_dice']:.6f}")
    steps = AVSS_STEPS + 1
    counts, plans = read_counts(), _plans()
    dtypes = dict(deform_attn_cuda.bwd_dtype_launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    want_plans = {"k1": {"staged": want["k1"], "grouped": 0, "global": 0},
                  "k2": {"level_slice": want["k2"], "global": 0},
                  "k4_dimg": {"staged": want["k4_dimg"], "global": 0},
                  "k7": {"patch": 0, "pixel": 0}}
    if counts != want or plans != want_plans or dtypes != {"float32": 0,
                                                           "bfloat16": want["k2"]}:
        raise AssertionError(f"[avss-train] launches {counts} by plan {plans}, K2 by type "
                             f"{dtypes} in {steps} steps; expected {want} by plan {want_plans}, "
                             "every K2 launch in bf16")
    for m in metrics:
        if set(m) != {"total_loss", *wd} or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"[avss-train] losses not finite or misnamed: {m}")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("[avss-train] the AMP step left a weight out of float32")
    med = float(np.median(times[1:AVSS_STEPS]))
    matcher_ms, solve_ms = clock.walls[0] * 1e3, clock.solve_walls[0] * 1e3
    log(f"[avss-train] {AVSS_STEPS - 1} timed AMP steps of [{AVSS_B}x{AVSS_T}x{SIZE}^2], "
        f"K={AVSS_K}, {AVSS_CLASSES} classes, bf16 forward: median {med:.4f} s/step "
        f"({AVSS_N / med:.1f} frames/s), warm-up {times[0]:.4f} s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; the matcher (10 outputs x {AVSS_N} frames of [12, 100] cost "
        f"matrices, one batched JV solve) {matcher_ms:.1f} ms of the {times[-1]:.4f} s step, the "
        f"solve {solve_ms:.1f} ms of it; launches per step "
        f"{ {k: v // steps for k, v in counts.items()} } (K2 by type {dtypes}, by plan "
        f"{plans['k2']}) on {smi}")
    return {"launches": counts, "s_per_step": med, "peak_bytes": peak, "times": times,
            "matcher_ms": matcher_ms, "solve_ms": solve_ms, "k2_dtypes": dtypes}


class SharedPoints:
    """The criterion's uncertain-point selection for a comparison of two
    passes: PointRend keeps the candidate points whose mask logits lie
    nearest 0, so logits that differ by rounding can select other points
    and take the mask losses on them. While active, the first pass records
    each call's points and the second takes them; `differ` counts the
    points where the second pass's own selection differed (ordered, so a
    reordering counts too)."""

    def __init__(self):
        self.recorded, self.replay = [], None
        self.points = self.differ = 0

    def __enter__(self):
        from combo_avs_torch.losses import criterion as criterion_mod

        self._module, self._real = criterion_mod, criterion_mod.uncertainty_sampled_points
        criterion_mod.uncertainty_sampled_points = self._shared
        return self

    def __exit__(self, *exc):
        self._module.uncertainty_sampled_points = self._real

    def _shared(self, *args, **kw):
        coords = self._real(*args, **kw)
        if self.replay is None:
            self.recorded.append(coords)
            return coords
        want = self.replay.pop(0)
        self.points += want.shape[0] * want.shape[1]
        self.differ += int((coords != want).any(-1).sum())
        return want


def phase_avss_amp_vs_fp32(model, cfg) -> dict:
    """The AMP forward's losses against the fp32 forward's on the card, the
    same weights, batch and injected draws, in eval mode (no dropout), no
    gradient. The bf16 pass takes the fp32 pass's discrete choices, each a
    threshold that rounding can cross: the matching (`SharedMatching`, its
    own held to what a near-tie allows), the decoder's attention masks
    (`SharedAttnMask`, likewise) and the uncertain points the mask losses
    are taken on (`SharedPoints`). Each loss within AVSS_AMP_LOSS_RTOL."""
    from combo_avs_torch.losses.criterion import build_criterion
    from combo_avs_torch.train.train_step import compute_losses

    dev = next(model.parameters()).device
    crit = build_criterion(cfg)
    matching = crit.matcher = SharedMatching(crit.matcher)
    masks = SharedAttnMask("avss-amp-vs-fp32", model, model)
    masks.models = (model,)  # one model, both passes: patched once
    batch = avss_batch(2, SIZE, dev, seed=SEED + 6)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    draws = [crit.draw(g, 2 * AVSS_T, AVSS_K) for _ in range(DEC_OUTPUTS)]
    model.eval()
    res = {}
    with torch.no_grad(), tf32_off(), masks, SharedPoints() as points:
        for name, amp in (("fp32", False), ("amp", True)):
            if amp:
                matching.replay = list(matching.recorded)
                masks.card_pass()
                points.replay = list(points.recorded)
            losses = compute_losses(model, crit, batch, torch.Generator(device=dev),
                                    draws=draws, amp=amp)
            res[name] = {k: float(v) for k, v in losses.items()}
    errs = {k: abs(res["amp"][k] - res["fp32"][k]) / max(1.0, abs(res["fp32"][k]))
            for k in res["fp32"]}
    worst = max(errs, key=errs.get)
    log(f"[avss-amp-vs-fp32] 2 videos x {AVSS_T} frames: {len(errs)} losses, worst {worst} "
        f"{res['amp'][worst]:.6f} (bf16) vs {res['fp32'][worst]:.6f} (fp32), rel err "
        f"{errs[worst]:.3e} (tol {AVSS_AMP_LOSS_RTOL}); the bf16 pass's own choices differed "
        f"from the fp32 pass's in {matching.differ} of {matching.slots} matched slots, "
        f"{masks.flipped} of {masks.positions} attention-mask positions (each a near-tie) "
        f"and {points.differ} of {points.points} uncertain points; it took the fp32 pass's; "
        "TF32 off")
    if errs[worst] > AVSS_AMP_LOSS_RTOL:
        raise AssertionError(f"[avss-amp-vs-fp32] {worst}: bf16 and fp32 losses disagree")
    return {"loss_rel_err": errs[worst], "worst": worst, "matching_differ": matching.differ,
            "attn_mask_flips": masks.flipped, "points_differ": points.differ}


def phase_avss_entry(smi: str, tmp: str, bare_s_per_step: float) -> dict:
    """The AVSS training entry point at full width: `train_net.main` on the
    shipped avs_ss/COMBO_R50_bs8_90k.yaml (bf16 AMP) over the synthetic AVSS
    tree under `tmp` (AVSS_TRAIN_VIDEOS train, AVSS_VAL_VIDEOS val videos, v1s,
    v1m and v2), AVSS_ENTRY_ITERS iterations with an evaluation (the AVSS
    evaluator's four metrics) and a checkpoint at the last: finite losses,
    each kernel's launches by plan (K1 6 a step and 6 an eval video, K2 6
    bf16 a step, K7 none: C = 71), a model_best.pth; no import of jax,
    flax, yaml, cv2, tensorflow or the JAX package. Returns the output
    directory's model_best.pth path in the result."""
    from combo_avs_torch import train_net
    from combo_avs_torch.ops import deform_attn_cuda

    out_dir = os.path.join(tmp, "avss_out")
    iters = AVSS_ENTRY_ITERS
    argv = ["--config-file", AVSS_CONFIG, "--datasets-root", tmp, "--log-every", "1",
            "OUTPUT_DIR", out_dir, "SOLVER.MAX_ITER", str(iters), "TEST.EVAL_PERIOD",
            str(iters), "SOLVER.CHECKPOINT_PERIOD", str(iters)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_imports("[avss-entry] train_net.main")
    counts, plans = read_counts(), _plans()
    dtypes = dict(deform_attn_cuda.bwd_dtype_launches)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "total_loss" in r]
    evals = [r for r in rows if "mIoU" in r]
    if [r["iter"] for r in steps] != list(range(1, iters + 1)) or not all(
            np.isfinite(r["total_loss"]) for r in steps):
        raise AssertionError(f"[avss-entry] logged steps {steps}")
    keys = {"mIoU", "f_score", "mIoU_noBg", "f_score_noBg"}
    if len(evals) != 1 or not keys <= set(evals[0]) or not all(
            np.isfinite(evals[0][k]) and 0.0 <= evals[0][k] <= 1.0 for k in keys):
        raise AssertionError(f"[avss-entry] evaluations {evals}, expected one with {keys}")
    want = {k: v * iters for k, v in TRAIN_LAUNCHES.items()}
    want["k1"] += 6 * AVSS_VAL_VIDEOS
    want_plans = {"k1": {"staged": want["k1"], "grouped": 0, "global": 0},
                  "k2": {"level_slice": want["k2"], "global": 0},
                  "k4_dimg": {"staged": want["k4_dimg"], "global": 0},
                  "k7": {"patch": 0, "pixel": 0}}
    if counts != want or plans != want_plans or dtypes["bfloat16"] != want["k2"]:
        raise AssertionError(f"[avss-entry] launches {counts} by plan {plans}, K2 by type "
                             f"{dtypes}; expected {want} by plan {want_plans}, K2 in bf16")
    best = os.path.join(out_dir, "model_best.pth")
    if not os.path.isfile(best) or f"step_{iters}" not in os.listdir(out_dir):
        raise AssertionError(f"[avss-entry] {sorted(os.listdir(out_dir))}: no model_best.pth "
                             f"or step_{iters}")
    timing = trainer.eval_timing.get(trainer.cfg.DATASETS.TEST[0])
    for r in steps:
        log(f"[avss-entry] iter {r['iter']}: total_loss {r['total_loss']:.6f}, "
            f"{r['s_per_iter']:.4f} s/iter, data_time {r['data_time']:.4f} s/iter (bare AMP step "
            f"{bare_s_per_step:.4f} s/step) on {smi}")
    ev = {k: evals[0][k] for k in sorted(keys)}
    log(f"[avss-entry] eval @ {evals[0]['iter']} on {trainer.cfg.DATASETS.TEST[0]}: {ev}; "
        f"{timing['videos']} videos in {timing['total_s']:.3f} s (data {timing['data_s']:.3f}, "
        f"compute {timing['compute_s']:.3f}, eval {timing['eval_s']:.3f}); {wall:.1f} s wall; "
        f"launches {counts} by plan {plans}, K2 by type {dtypes}; model_best.pth written")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": counts, "plans": plans, "rows": steps, "eval": ev,
            "eval_timing": timing, "wall_s": wall, "model_best": best}


def phase_avss_pred(smi: str, tmp: str, checkpoint: str) -> dict:
    """The AVSS evaluation entry point as a user runs it: `pred --config-file
    avs_ss/Test_COMBO_R50_bs8_90k.yaml` with the model_best.pth of
    avss-entry, no `--dataset` or `--bf16`, over the synthetic test split
    (AVSS_TEST_VIDEOS videos, both frame buckets) at batch EVAL_BATCH: it
    must score avss_sem_seg_test in bf16 (TEST.BF16 "auto") with the AVSS
    evaluator; its four metrics in [0, 1], its timers, K1 6 and K7 0 per
    batch."""
    from unittest import mock

    from combo_avs_torch import pred
    from combo_avs_torch.train import evaluate as evaluate_mod

    buckets = {5: AVSS_TEST_VIDEOS - AVSS_TEST_VIDEOS // 3, 10: AVSS_TEST_VIDEOS // 3}
    batches = sum(-(-n // EVAL_BATCH) for n in buckets.values())
    timings = []
    with mock.patch.object(evaluate_mod, "evaluate", timed_evaluate(timings)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = pred.main(["--datasets-root", tmp, "--checkpoint", checkpoint, "--config-file",
                         AVSS_TEST_CONFIG, "--batch-size", str(EVAL_BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_imports("[avss-pred] pred.main")
    counts = read_counts()
    want = {k: {"k1": 6 * batches}.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"[avss-pred] launches {counts}, expected {want} ({batches} "
                             "batches: K1 6 and K7 0 a batch)")
    m, (tm,) = res["sem_seg"], timings
    scored = (tm["dataset"], tm["bf16"], tm["evaluator"])
    if scored != ("avss_sem_seg_test", True, "SemSegEvaluatorSS"):
        raise AssertionError(f"[avss-pred] pred scored {scored}, expected the config's "
                             "avss_sem_seg_test in bf16 with the AVSS evaluator")
    if set(m) != {"mIoU", "f_score", "mIoU_noBg", "f_score_noBg"} or not all(
            np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()) or \
            tm["videos"] != AVSS_TEST_VIDEOS:
        raise AssertionError(f"[avss-pred] metrics {m} over {tm['videos']} videos")
    log(f"[avss-pred] {tm['dataset']} (the config's DATASETS.TEST, no --dataset), bf16 "
        f"(TEST.BF16 auto), {batches} batches of {EVAL_BATCH} ({buckets[5]} 5-frame and "
        f"{buckets[10]} 10-frame videos): {m}; {tm['videos']} videos, {tm['frames']} frames in "
        f"{tm['total_s']:.3f} s (data {tm['data_s']:.3f}, compute {tm['compute_s']:.3f}, eval "
        f"{tm['eval_s']:.3f}): {tm['videos'] / tm['total_s']:.2f} videos/s; pred.main "
        f"{wall:.1f} s wall; launches {counts} on {smi}")
    return {"metrics": m, "timing": tm, "launches": counts, "wall_s": wall}


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def ddp_step_fn(model, world, dropout_seed: int):
    """A training step of `model` as one rank of `world` (the criterion's
    generator seeded SEED on every rank, dropout from `dropout_seed`) and
    its optimizer: with `keep` set, the optimizer appends to `grads` the
    flat gradient that reached its clip (on the host) at each step."""
    from combo_avs_torch.losses.criterion import SetCriterion, build_weight_dict
    from combo_avs_torch.train.optim import Optimizer
    from combo_avs_torch.train.train_step import make_train_step

    class Keeping(Optimizer):
        keep = False

        def step(self):
            if self.keep:
                self.grads.append(flat(p.grad if p.grad is not None else torch.zeros_like(p)
                                       for p in self.params).cpu())
            super().step()

    dev = next(model.parameters()).device
    opt = Keeping(model)
    opt.grads = []
    step = make_train_step(model, SetCriterion(), build_weight_dict(), opt,
                           torch.Generator(device=dev).manual_seed(SEED),
                           dropout_generator=torch.Generator(device=dev).manual_seed(dropout_seed),
                           world=world)
    return step, opt


def ddp_rank(rank: int, d: str) -> None:
    """One rank of the ddp phase's parts (a) and (c), spawned: card 0 shared
    with the other rank over gloo, TF32 off, dropout off. Writes
    d/rank<rank>.json (rank 0 also d/steps.pt: each step's gradient before
    the clip and the weights after it)."""
    from combo_avs_torch.data.catalogs import register_all
    from combo_avs_torch.models import fusion
    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import MaskFormer
    from combo_avs_torch.parallel import distributed
    from combo_avs_torch.parallel.mesh import shard_batch
    from combo_avs_torch.train.evaluate import evaluate
    from combo_avs_torch.utils.profiling import device_timer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    fusion.DROPOUT = 0.0
    distributed.initialize("file://" + os.path.join(d, "rendezvous"), DDP_RANKS, rank,
                           backend="gloo", device=dev)
    world = distributed.current()
    model = init_weights(MaskFormer(), seed=SEED)
    distributed.broadcast_module_(model, world)
    batch = shard_batch(train_batch(TRAIN_B, SIZE, dev, seed=SEED), rank, DDP_RANKS)
    step, opt = ddp_step_fn(model, world, distributed.rank_seed(SEED, rank))

    # the compared steps: rank 0 keeps each step's gradient and weights
    opt.keep = rank == 0
    metrics, weights = [], []
    reset_counts()
    for _ in range(DDP_STEPS):
        metrics.append({k: float(v) for k, v in step(batch).items()})
        if opt.keep:
            weights.append(flat(opt.params).cpu())
    counts, plans = read_counts(), _plans()
    if opt.keep:
        torch.save({"grads": opt.grads, "weights": weights}, os.path.join(d, "steps.pt"))
    opt.keep = False
    del weights
    opt.grads.clear()

    # the timed steps (utils/profiling.py::device_timer, the first a warm-up)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s_per_step = device_timer(step, batch, iters=1, repeats=DDP_STEPS - 1)
    peak_bytes = torch.cuda.max_memory_allocated()
    grads = [p.grad for p in opt.params if p.grad is not None]
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    trainable = sum(g.numel() for g in grads)
    allreduce_s = device_timer(distributed.all_sum_tensors_, grads, world, iters=1, repeats=2)
    del grads, step, opt
    model.zero_grad(set_to_none=True)

    register_all(d)
    init_weights(model, seed=SEED).eval()
    reset_counts()
    res, timing = evaluate(model, "avss4_sem_seg_val", batch_size=1, size=SIZE, world=world)
    row = dict(rank=rank, world=world.size, metrics=metrics, counts=counts, plans=plans,
               s_per_step=s_per_step, peak_bytes=peak_bytes, allreduce_s=allreduce_s,
               grad_bytes=grad_bytes, trainable=trainable, eval_metrics=res["sem_seg"],
               eval_videos=timing["videos"], eval_counts=read_counts(), eval_plans=_plans())
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    distributed.dist.destroy_process_group()


def ddp_check_ranks(tag: str, tmp: str, rows: list, dev: torch.device, smi: str) -> dict:
    """The ddp phase's parts (a) and (c) held against one process: the
    same steps on the whole batch, each from the weights the ranks' step
    before it left, and the same evaluation here."""
    from combo_avs_torch.data.catalogs import register_all
    from combo_avs_torch.models import fusion
    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import MaskFormer
    from combo_avs_torch.parallel import distributed
    from combo_avs_torch.train.evaluate import evaluate

    kept = torch.load(os.path.join(tmp, "steps.pt"))
    saved_dropout = fusion.DROPOUT
    fusion.DROPOUT = 0.0
    steps = []
    try:
        with tf32_off():
            model = init_weights(MaskFormer(), seed=SEED)
            step, opt = ddp_step_fn(model, distributed.World(), distributed.rank_seed(SEED, 0))
            opt.keep = True
            names = {id(p): n for n, p in model.named_parameters()}
            leaves = [names[id(p)] for p in opt.params]
            sizes = [p.numel() for p in opt.params]
            lr = max(g["lr"] for g in opt.inner.param_groups)
            batch = train_batch(TRAIN_B, SIZE, dev, seed=SEED)
            reset_counts()
            for k in range(DDP_STEPS):
                if k:  # start from the ranks' weights
                    with torch.no_grad():
                        for p, w in zip(opt.params, torch.split(kept["weights"][k - 1].to(dev),
                                                                sizes)):
                            p.copy_(w.view_as(p))
                m = {n: float(v) for n, v in step(batch).items()}
                loss_err = max(abs(r["metrics"][k][n] - v) / max(1.0, abs(v))
                               for r in rows for n, v in m.items())
                gc, gr = opt.grads[k].to(dev).double(), kept["grads"][k].to(dev).double()
                norm_ref, norm_ranks = float(gc.norm()), float(gr.norm())
                rl2 = {leaf: float((a - b).norm()) / max(float(a.norm()), float(b.norm()),
                                                        GRAD_FLOOR * norm_ref)
                       for leaf, a, b in zip(leaves, torch.split(gr, sizes),
                                             torch.split(gc, sizes))}
                worst_leaf = max(rl2, key=rl2.get)
                wc, wr = flat(opt.params), kept["weights"][k].to(dev)
                dw = (wr - wc).abs()
                moved = dw > 0.5 * lr  # apart by more than half the rate
                steps.append({
                    "loss_rel_err": loss_err, "worst_leaf": worst_leaf,
                    "grad_rl2_leaf": rl2[worst_leaf],
                    "grad_norm_rel_err": abs(norm_ranks - norm_ref) / norm_ref,
                    "grad_norm": norm_ref,
                    "weight_rel_err": float(dw.max() / wc.abs().max()),
                    "weights_apart": int(moved.sum()),
                    "apart_opposite_grads": int((moved & (torch.sign(gc) != torch.sign(gr)))
                                                .sum()),
                    "metrics": m})
                del gc, gr, wc, wr, dw, moved
            counts, plans = read_counts(), _plans()
            del step, opt
            model.zero_grad(set_to_none=True)
            register_all(tmp)
            init_weights(model, seed=SEED).eval()
            one_eval, _ = evaluate(model, "avss4_sem_seg_val", batch_size=1, size=SIZE)
    finally:
        fusion.DROPOUT = saved_dropout
    del model, kept
    torch.cuda.empty_cache()

    for r in rows:
        log(f"[{tag}] rank {r['rank']} of {r['world']} (gloo, card 0 shared): "
            f"{r['s_per_step'] * 1e3:.1f} ms/step (best of {DDP_STEPS - 1} after a warm-up, "
            f"utils/profiling.py::device_timer), gradient all-reduce "
            f"{r['allreduce_s'] * 1e3:.1f} ms a step ({r['trainable']} trainable "
            f"parameters, {r['grad_bytes'] / 1e6:.1f} MB fp32 in buckets of at most "
            f"{distributed.BUCKET_BYTES >> 20} MiB), max_memory_allocated {r['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches in the {DDP_STEPS} compared steps {r['counts']} by plan {r['plans']} "
            f"on {smi}")
    log(f"[{tag}] one process, the whole batch, each step from the ranks' weights: launches "
        f"{counts} by plan {plans}")
    for k, st in enumerate(steps):
        log(f"[{tag}] step {k + 1}, {DDP_RANKS} ranks against one process: worst loss rel err "
            f"{st['loss_rel_err']:.3e} (tol {LOSS_RTOL_CPU}); gradient worst leaf "
            f"{st['worst_leaf']} rel-L2 {st['grad_rl2_leaf']:.3e} (tol {GRAD_RL2_LEAF}), global "
            f"norm {st['grad_norm']:.6e} rel err {st['grad_norm_rel_err']:.3e} (tol "
            f"{DDP_GRAD_NORM_RTOL}); updated weights max diff over max weight "
            f"{st['weight_rel_err']:.3e} (tol {DDP_WEIGHT_RTOL}), {st['weights_apart']} "
            f"entries apart by more than half the rate {lr:.1e}, of which "
            f"{st['apart_opposite_grads']} have gradients of opposite signs; TF32 off, "
            f"dropout off")
    bad = [k + 1 for k, st in enumerate(steps)
           if st["loss_rel_err"] > LOSS_RTOL_CPU or st["grad_rl2_leaf"] > GRAD_RL2_LEAF
           or st["grad_norm_rel_err"] > DDP_GRAD_NORM_RTOL
           or st["weight_rel_err"] > DDP_WEIGHT_RTOL]
    if bad:
        raise AssertionError(f"[{tag}] the ranks' steps {bad} disagree with one process's")
    steps_want = {k: v * DDP_STEPS for k, v in TRAIN_LAUNCHES.items()}
    eval_want = dict.fromkeys(TRAIN_LAUNCHES, 0)
    for r in rows:
        eval_want.update(k1=6 * r["eval_videos"], k7=r["eval_videos"])
        if r["counts"] != steps_want or r["eval_counts"] != eval_want:
            raise AssertionError(f"[{tag}] rank {r['rank']}: launches {r['counts']} in "
                                 f"{DDP_STEPS} steps and {r['eval_counts']} in the "
                                 f"evaluation, expected {steps_want} and {eval_want}")
    # (c) the merged evaluation
    eval_err = max(abs(r["eval_metrics"][k] - v) for r in rows
                   for k, v in one_eval["sem_seg"].items())
    log(f"[{tag}] evaluation of {DDP_VAL_VIDEOS} val videos on {DDP_RANKS} ranks "
        f"({[r['eval_videos'] for r in rows]} videos each), merged {rows[0]['eval_metrics']}, "
        f"one process {one_eval['sem_seg']}: max diff {eval_err:.1e} (tol {DDP_METRIC_ATOL}); "
        f"launches a rank {[r['eval_counts'] for r in rows]}")
    if eval_err > DDP_METRIC_ATOL or any(set(r["eval_metrics"]) != set(one_eval["sem_seg"])
                                         for r in rows):
        raise AssertionError(f"[{tag}] the ranks' evaluation differs from one process's")
    return {"steps": steps, "eval_max_diff": eval_err}


def phase_ddp(smi: str, dev: torch.device) -> dict:
    """Data parallelism at full width (see DDP_RANKS): (a) and (c) in
    DDP_RANKS spawned ranks on card 0 over gloo, held against this process;
    (b) `python -m combo_avs_torch.train_net --num-devices <cards>` over NCCL
    (NCCL_DEBUG=INFO must show its communicator), held against a one-process
    `Trainer.test` of its checkpoint."""
    import tempfile

    from combo_avs_torch import config
    from combo_avs_torch.data.catalogs import register_all
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.train.trainer import Trainer

    tag = "ddp"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_s4(tmp, DDP_TRAIN_VIDEOS, DDP_VAL_VIDEOS, size=SIZE)
        t0 = time.perf_counter()
        torch.multiprocessing.start_processes(ddp_rank, args=(tmp,), nprocs=DDP_RANKS,
                                              join=True, start_method="spawn")
        out["ranks_wall_s"] = time.perf_counter() - t0
        rows = []
        for r in range(DDP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                rows.append(json.load(f))

        # (b) train_net over NCCL, one rank a card, in a process of its own,
        # beside this process's reference steps and checks
        cards = torch.cuda.device_count()
        out_dir = os.path.join(tmp, "entry")
        cmd = [sys.executable, "-m", "combo_avs_torch.train_net", "--config-file", R50_CONFIG,
               "--datasets-root", tmp, "--num-devices", str(cards), "--max-iter",
               str(DDP_ENTRY_ITERS), "--log-every", "1", "OUTPUT_DIR", out_dir,
               "TEST.EVAL_PERIOD", str(DDP_ENTRY_ITERS), "SOLVER.CHECKPOINT_PERIOD",
               str(DDP_ENTRY_ITERS)]
        env = dict(os.environ, NCCL_DEBUG="INFO",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t_entry = time.perf_counter()
        entry = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            checked = ddp_check_ranks(tag, tmp, rows, dev, smi)
            stdout, stderr = entry.communicate(timeout=600)
        finally:
            if entry.poll() is None:
                entry.kill()
                entry.wait()
        entry_wall = time.perf_counter() - t_entry
        if entry.returncode:
            raise AssertionError(f"[{tag}] train_net --num-devices {cards} exited "
                                 f"{entry.returncode}:\n{stderr[-3000:]}")
        nccl = [line for line in (stdout + stderr).splitlines() if "NCCL INFO" in line]
        shown = [line for line in nccl if "Init COMPLETE" in line or "nranks" in line] or nccl
        if not nccl:
            raise AssertionError(f"[{tag}] train_net --num-devices {cards}: no NCCL "
                                 "communicator in its output")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            entry_rows = [json.loads(line) for line in f]
        iters = [r["iter"] for r in entry_rows if "total_loss" in r]
        evals = [r for r in entry_rows if "mIoU" in r]
        names = set(os.listdir(out_dir))
        if (iters != list(range(1, DDP_ENTRY_ITERS + 1)) or len(evals) != 1
                or not {f"step_{DDP_ENTRY_ITERS}", "model_best.pth"} <= names):
            raise AssertionError(f"[{tag}] train_net --num-devices {cards}: iterations {iters}, "
                                 f"evaluations {evals}, files {sorted(names)}")
        register_all(tmp)
        trainer = Trainer(config.setup_cfg(R50_CONFIG, ["OUTPUT_DIR", out_dir]))
        trainer.resume_or_load(resume=True)
        if trainer.world.size != 1 or trainer.start_iter != DDP_ENTRY_ITERS:
            raise AssertionError(f"[{tag}] the checkpoint resumed at {trainer.start_iter}")
        one = trainer.test()["sem_seg"]
        del trainer
        torch.cuda.empty_cache()
        merged = {k: evals[0][k] for k in one}
        log(f"[{tag}] train_net --num-devices {cards} (NCCL, {len(nccl)} NCCL INFO lines, e.g. "
            f"{shown[-1].strip()[:160]!r}): {DDP_ENTRY_ITERS} iterations, losses "
            f"{[round(r['total_loss'], 4) for r in entry_rows if 'total_loss' in r]}, s/iter "
            f"{[r['s_per_iter'] for r in entry_rows if 'total_loss' in r]}, merged "
            f"eval {merged}; one-process Trainer.test of step_{DDP_ENTRY_ITERS}: {one}; "
            f"{entry_wall:.1f} s wall")
        if merged != one:
            raise AssertionError(f"[{tag}] train_net's merged metrics {merged} differ from the "
                                 f"one-process evaluation {one}")
    out.update(checked, rows=rows, entry_wall_s=entry_wall, entry_cards=cards,
               entry_metrics=merged)
    return out


def phase_avss(smi: str, dev: torch.device, walls: dict) -> dict:
    """COMBO-R50 on AVSS at full width: `build_model` of the shipped
    avs_ss/COMBO_R50_bs8_90k.yaml (71 classes) with seeded weights on the
    card, the AMP step (avss-train), its losses against fp32's
    (avss-amp-vs-fp32), then `train_net` on that config (avss-entry) and
    `pred` on its Test config with the model_best.pth that wrote
    (avss-pred), both over one synthetic AVSS tree."""
    import tempfile

    from combo_avs_torch.config import setup_cfg
    from combo_avs_torch.data.synth import make_avss
    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import build_model

    cfg = setup_cfg(AVSS_CONFIG)
    t0 = time.perf_counter()
    model = init_weights(build_model(cfg), seed=SEED)
    classes = model.sem_seg_head.predictor.class_embed.out_features - 1
    if next(model.parameters()).device != dev or classes != AVSS_CLASSES:
        raise AssertionError(f"[avss-model] {classes} classes on "
                             f"{next(model.parameters()).device}")
    log(f"[avss-model] build_model({os.path.relpath(AVSS_CONFIG, REPO)}): {classes} classes, "
        f"SOLVER.AMP.ENABLED {cfg.SOLVER.AMP.ENABLED}, seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    t0 = time.perf_counter()
    out["train"] = phase_avss_train(smi, model, cfg)
    walls["avss-train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["amp_vs_fp32"] = phase_avss_amp_vs_fp32(model, cfg)
    walls["avss-amp-vs-fp32"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_avss(tmp, AVSS_TRAIN_VIDEOS, AVSS_VAL_VIDEOS, AVSS_TEST_VIDEOS, size=SIZE)
        frames = [os.path.join(d, f) for d, _, fs in os.walk(tmp) for f in fs
                  if os.path.basename(d) == "processed_frames" and "pre_SAM_mask" not in d]
        jpegs = [f for f in frames if f.endswith(".jpg") and open(f, "rb").read(2) == b"\xff\xd8"]
        if not frames or len(jpegs) != len(frames):
            raise AssertionError(f"[avss-entry] {len(jpegs)} of {len(frames)} frames are JPEG")
        log(f"[avss-entry] synthetic AVSS tree: {AVSS_TRAIN_VIDEOS} train, {AVSS_VAL_VIDEOS} val "
            f"and {AVSS_TEST_VIDEOS} test videos (v1s, v1m: 5 frames; v2: 10) x {SIZE}^2, "
            f"{len(jpegs)} frames JPEG (q95, 4:2:0, as AVSBench-semantic's), Maskiges and "
            f"labels PNG, in {time.perf_counter() - t0:.1f} s")
        out["entry"] = phase_avss_entry(smi, tmp, out["train"]["s_per_step"])
        walls["avss-entry"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["pred"] = phase_avss_pred(smi, tmp, out["entry"]["model_best"])
        walls["avss-pred"] = time.perf_counter() - t0
    tr = out["train"]
    out["summary"] = {
        "config": os.path.relpath(AVSS_CONFIG, REPO),
        "train": {"s_per_step": tr["s_per_step"], "step_times_s": tr["times"],
                  "max_memory_allocated": tr["peak_bytes"], "matcher_ms": tr["matcher_ms"],
                  "solve_ms": tr["solve_ms"],
                  "launches_per_step": {k: v // (AVSS_STEPS + 1)
                                        for k, v in tr["launches"].items()},
                  "shape": f"{AVSS_B}x{AVSS_T}x{SIZE}^2 K={AVSS_K} C={AVSS_CLASSES} bf16 AMP"},
        "amp_vs_fp32": out["amp_vs_fp32"],
        "entry": {k: out["entry"][k] for k in ("rows", "eval", "eval_timing", "wall_s")},
        "pred": {k: out["pred"][k] for k in ("metrics", "timing", "wall_s")},
    }
    return out


def variant_launches(deform: bool, eval_step: bool) -> dict:
    """K1-K7 launches of one step of a variant: the eval step K1 6 (the
    deformable encoder) and K7 1; the train step TRAIN_LAUNCHES; the FPN
    pixel decoders launch no K1 or K2."""
    if eval_step:
        want = {k: 0 for k in TRAIN_LAUNCHES}
        want.update(k1=6, k7=1)
    else:
        want = dict(TRAIN_LAUNCHES)
    if not deform:
        want.update(k1=0, k2=0)
    return want


def phase_variants(smi: str, dev: torch.device) -> dict:
    """Each model of VARIANTS at full R50 width from `build_model` of the
    shipped S4 config with its overrides, seeded weights: one bf16 eval step
    (after a warm-up) at B x T x 224^2 and one fp32 train step (after a
    warm-up) at TRAIN_B x T x 224^2, K = TRAIN_K, with the config's
    criterion, weights and optimizer; the step walls, the train step's peak
    memory, finite losses named as the config's weights, every kernel's
    launches by plan against `variant_launches`; the model without the SEM
    tower gets batches without Maskiges; a trained VGGish tower (d) changes,
    a frozen one does not. Then, on VARIANTS_VS_CPU, the card-vs-CPU forward
    (phase 8)."""
    from combo_avs_torch.config import setup_cfg
    from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict
    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import build_model
    from combo_avs_torch.train.optim import build_optimizer
    from combo_avs_torch.train.train_step import make_eval_step, make_train_step

    rows = {}
    for name, opts in VARIANTS.items():
        tag = f"variants {name}"
        cfg = setup_cfg(R50_CONFIG, opts)
        t0 = time.perf_counter()
        model = init_weights(build_model(cfg), seed=SEED)
        if next(model.parameters()).device != dev:
            raise AssertionError(f"[{tag}] build_model did not build on the card")
        build_s = time.perf_counter() - t0
        deform = cfg.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME == "MSDeformAttnPixelDecoder"
        pre_sam = cfg.MODEL.PRE_SAM.USE_PRE_SAM
        row = {"params": sum(p.numel() for p in model.parameters()), "build_s": build_s}

        # eval, bf16
        batch = _batch(np.random.RandomState(SEED), dev)
        if not pre_sam:
            del batch["pre_masks"]
        step = make_eval_step(model, out_size=(SIZE, SIZE), bf16=True)
        step(batch)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sem = step(batch)
        torch.cuda.synchronize()
        row["eval_s"] = time.perf_counter() - t0
        counts, plans = read_counts(), _plans()
        want = variant_launches(deform, eval_step=True)
        if counts != want or plans["k7"]["patch"] != 1 or \
                sum(plans["k1"].values()) != want["k1"]:
            raise AssertionError(f"[{tag}] eval launches {counts} by plan {plans}, expected "
                                 f"{want} (K7 through patch)")
        if tuple(sem.shape) != (B * T, 2, SIZE, SIZE) or not bool(torch.isfinite(sem).all()):
            raise AssertionError(f"[{tag}] eval output {tuple(sem.shape)} not finite")
        row["eval_launches"], row["eval_plans"] = counts, plans
        del step, sem

        # train, fp32
        wd = build_weight_dict(cfg)
        opt = build_optimizer(cfg, model)
        tstep = make_train_step(model, build_criterion(cfg), wd, opt,
                                torch.Generator(device=dev).manual_seed(SEED))
        tb = train_batch(TRAIN_B, SIZE, dev, seed=SEED)
        if not pre_sam:
            del tb["pre_masks"]
        audio0 = [p.detach().clone() for p in model.audio_backbone.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = tstep(tb)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        m1 = tstep(tb)
        torch.cuda.synchronize()
        row["train_s"] = time.perf_counter() - t0
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        counts, plans = read_counts(), _plans()
        want = variant_launches(deform, eval_step=False)
        if counts != want or plans["k4_dimg"]["staged"] != want["k4_dimg"]:
            raise AssertionError(f"[{tag}] train launches {counts} by plan {plans}, "
                                 f"expected {want} (K4 dimg through staged)")
        metrics = [{k: float(v) for k, v in m.items()} for m in (m0, m1)]
        for m in metrics:
            if set(m) != {"total_loss", *wd} or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"[{tag}] losses not finite or misnamed: {sorted(m)}")
        audio_moved = any(not torch.equal(a, p) for a, p in zip(
            audio0, model.audio_backbone.parameters()))
        if audio_moved != (not cfg.MODEL.AUDIO.FREEZE_AUDIO_EXTRACTOR):
            raise AssertionError(f"[{tag}] the VGGish tower moved: {audio_moved}, frozen: "
                                 f"{cfg.MODEL.AUDIO.FREEZE_AUDIO_EXTRACTOR}")
        row.update(train_launches=counts, train_plans=plans, losses=metrics[-1],
                   optimizer=type(opt.inner).__name__,
                   n_cosine=sum(k.startswith("loss_cosine") for k in wd))
        log(f"[{tag}] {row['params']} parameters (built in {build_s:.1f} s); bf16 eval step "
            f"[{B}x{T}x{SIZE}^2] {row['eval_s']:.4f} s, launches {row['eval_launches']}; fp32 "
            f"train step [{TRAIN_B}x{T}x{SIZE}^2] K={TRAIN_K} {row['train_s']:.4f} s, "
            f"max_memory_allocated {row['peak_bytes'] / 2**30:.2f} GiB, {row['optimizer']}, "
            f"total_loss {metrics[-1]['total_loss']:.6f} ({len(wd)} weighted losses, "
            f"{row['n_cosine']} cosine), VGGish trained: {audio_moved}; launches {counts} "
            f"on {smi}")
        del tstep, opt, tb, m0, m1
        if name in VARIANTS_VS_CPU:
            t0 = time.perf_counter()
            twin = cpu_twin(model, lambda d, c=cfg: build_model(c, d))
            row["card_vs_cpu"] = phase_card_vs_cpu(model, twin, tag=f"{tag} card-vs-cpu")
            row["card_vs_cpu_s"] = time.perf_counter() - t0
            del twin
        rows[name] = row
        del model
        torch.cuda.empty_cache()
    check_imports("[variants] build_model and the steps")
    return rows


def phase_variant_entry(smi: str) -> dict:
    """The entry points on a variant as a user runs them: `train_net.main` on
    the shipped S4 config with VARIANT_ENTRY_OPTS (model (a), no SEM tower,
    MHA-S, and SGD) over a synthetic S4 tree, 2 iterations with an evaluation
    and a checkpoint at 2; then `pred.main` with the same config and
    overrides on its model_best.pth over the val split (bf16, TEST.BF16
    auto). The mapper ships no Maskiges; every iteration is logged with
    finite losses; each kernel launches as the steps and the eval batches
    imply; the metrics lie in [0, 1]; nothing of jax, flax, yaml, cv2 or the
    JAX package is imported."""
    import tempfile

    from combo_avs_torch import pred, train_net
    from combo_avs_torch.config import setup_cfg
    from combo_avs_torch.data.catalogs import DatasetCatalog, register_all
    from combo_avs_torch.data.synth import make_s4
    from combo_avs_torch.train.trainer import build_mapper

    tag = "variant-entry"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_s4(tmp, ENTRY_TRAIN_VIDEOS, VARIANT_VAL_VIDEOS, size=SIZE)
        cfg = setup_cfg(R50_CONFIG, VARIANT_ENTRY_OPTS)
        register_all(tmp)
        sample = build_mapper(cfg, is_train=True)(DatasetCatalog["avss4_sem_seg_train"]()[0], 0)
        if "pre_masks" in sample:
            raise AssertionError(f"[{tag}] the mapper shipped Maskiges to a model without SEM")
        out_dir = os.path.join(tmp, "out")
        argv = ["--config-file", R50_CONFIG, "--datasets-root", tmp, "--log-every", "1",
                "OUTPUT_DIR", out_dir, "SOLVER.MAX_ITER", str(ENTRY_ITERS), "TEST.EVAL_PERIOD",
                str(ENTRY_ITERS), "SOLVER.CHECKPOINT_PERIOD", str(ENTRY_ITERS),
                *VARIANT_ENTRY_OPTS]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_net.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_imports(f"[{tag}] train_net.main")
        if type(trainer.optimizer.inner).__name__ != "TraceSGD" or trainer.model.use_pre_sam:
            raise AssertionError(f"[{tag}] trained {type(trainer.optimizer.inner).__name__}, "
                                 f"SEM {trainer.model.use_pre_sam}")
        counts = read_counts()
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r for r in rows if "total_loss" in r]
        evals = [r for r in rows if "mIoU" in r]
        if [r["iter"] for r in steps] != list(range(1, ENTRY_ITERS + 1)) or \
                not all(np.isfinite(r["total_loss"]) for r in steps) or len(evals) != 1:
            raise AssertionError(f"[{tag}] logged {rows}")
        want = {k: v * ENTRY_ITERS for k, v in TRAIN_LAUNCHES.items()}
        want["k1"] += 6 * VARIANT_VAL_VIDEOS
        want["k7"] += VARIANT_VAL_VIDEOS
        if counts != want:
            raise AssertionError(f"[{tag}] train_net launches {counts}, expected {want}")
        out["train_net"] = {"wall_s": wall, "rows": steps, "evals": evals, "launches": counts}
        log(f"[{tag}] train_net.main {ENTRY_ITERS} iterations of model (a) + SGD: "
            + ", ".join(f"iter {r['iter']} total_loss {r['total_loss']:.6f} "
                        f"{r['s_per_iter']:.4f} s/iter" for r in steps)
            + f"; eval mIoU {evals[0]['mIoU']:.4f}; {wall:.1f} s wall; launches {counts} on {smi}")
        del trainer
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        res = pred.main(["--datasets-root", tmp, "--checkpoint",
                         os.path.join(out_dir, "model_best.pth"), "--config-file", R50_CONFIG,
                         "--batch-size", str(EVAL_BATCH), *VARIANT_ENTRY_OPTS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_imports(f"[{tag}] pred.main")
        counts = read_counts()
        batches = -(-VARIANT_VAL_VIDEOS // EVAL_BATCH)
        want = {k: {"k1": 6 * batches, "k7": batches}.get(k, 0) for k in counts}
        m = res["sem_seg"]
        if counts != want or set(m) != {"mIoU", "f_score"} or not all(
                np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
            raise AssertionError(f"[{tag}] pred: {m}, launches {counts}, expected {want}")
        out["pred"] = {"wall_s": wall, "metrics": m, "launches": counts}
        log(f"[{tag}] pred.main on its model_best.pth (bf16, {batches} batch(es) of "
            f"{EVAL_BATCH}): {m}; {wall:.1f} s wall; launches {counts} on {smi}")
    return out


def phase_tools(smi: str, dev: torch.device) -> dict:
    """The offline tools on the card's host: `preprocess_audio` (its CLI, on
    the card) on a synthetic 10 s 44.1 kHz stereo wav, its pickle held to the
    CPU frontend within TOOLS_LOG_MEL_ATOL and read by the mappers'
    `load_audio`; `maskige` on synthetic SAM masks and `resize_frames` on a
    synthetic AVSS video (JPEG frames, gray PNG labels), whose outputs the
    port's image reader reads at the expected shapes. The CPU tests hold
    the tools' outputs to the JAX tools' (cv2)."""
    import pickle
    import tempfile

    from scipy.io import wavfile

    from combo_avs_torch.data.image import read_image
    from combo_avs_torch.data.jpeg import write_jpeg
    from combo_avs_torch.data.mappers import load_audio
    from combo_avs_torch.data.png import write_png
    from combo_avs_torch.tools import maskige, preprocess_audio, resize_frames

    tag = "tools"
    rng = np.random.RandomState(SEED)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        vid = os.path.join(tmp, "video0")
        os.makedirs(os.path.join(vid, "frames"))
        os.makedirs(os.path.join(vid, "labels_semantic"))
        rate, secs = 44100, 10
        t = np.arange(rate * secs) / rate
        wave = np.stack([0.4 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)],
                        -1) + 0.05 * rng.randn(t.size, 2)
        wav = os.path.join(vid, "audio.wav")
        wavfile.write(wav, rate, (wave * 32767 * 0.8).astype(np.int16))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if preprocess_audio.main(["--root", tmp]) != 1:
            raise AssertionError(f"[{tag}] preprocess_audio wrote no pickle")
        torch.cuda.synchronize()
        audio_s = time.perf_counter() - t0
        with open(os.path.join(vid, "audio.pkl"), "rb") as f:
            got = pickle.load(f)
        want = preprocess_audio.process_wav(wav, device="cpu")
        err = float(np.abs(got - want).max())
        if got.shape != (10, 1, 96, 64) or got.dtype != np.float32 or err > TOOLS_LOG_MEL_ATOL:
            raise AssertionError(f"[{tag}] audio.pkl {got.shape} {got.dtype}, max |card - cpu| "
                                 f"{err:.3e} (atol {TOOLS_LOG_MEL_ATOL})")
        mel = load_audio(os.path.join(vid, "audio.pkl"))
        out["audio"] = {"max_abs_err": err, "wall_s": audio_s}
        log(f"[{tag}] preprocess_audio on the card: {secs} s {rate} Hz stereo -> "
            f"{got.shape} log-mel, max |card - cpu| {err:.3e} (atol {TOOLS_LOG_MEL_ATOL}), "
            f"{audio_s:.2f} s wall (the first call's FFT plan included); load_audio "
            f"{mel.shape} on {smi}")

        masks = np.zeros((6, 360, 640), bool)
        for k in range(6):
            y, x = rng.randint(0, 300), rng.randint(0, 560)
            masks[k, y:y + rng.randint(20, 360 - y), x:x + rng.randint(20, 640 - x)] = True
        sam_dir = os.path.join(tmp, "pre_SAM_mask", "video0")
        os.makedirs(sam_dir)
        for i in range(3):
            np.save(os.path.join(sam_dir, f"{i}.npy"), masks[: 2 * i + 2])
            write_jpeg(os.path.join(vid, "frames", f"{i}.jpg"),
                       rng.randint(0, 256, (360, 640, 3)).astype(np.uint8))
            lab = np.zeros((360, 640), np.uint8)
            lab[100:200, 200:400] = i + 1
            write_png(os.path.join(vid, "labels_semantic", f"{i}.png"), lab)
        t0 = time.perf_counter()
        n_mask = maskige.main(["--root", sam_dir])
        n_img = resize_frames.main(["--root", tmp, "--mode", "crop"])
        tools_s = time.perf_counter() - t0
        rgb = read_image(os.path.join(sam_dir, "0_mask_color.png"))
        frame = read_image(os.path.join(vid, "processed_frames", "0.jpg"))
        label = read_image(os.path.join(vid, "processed_labels_semantic", "0.png"), gray=True)
        if (n_mask, n_img) != (3, 6) or rgb.shape != (SIZE, SIZE, 3) or \
                frame.shape != (SIZE, SIZE, 3) or label.shape != (SIZE, SIZE) or \
                set(np.unique(label)) - {0, 1}:
            raise AssertionError(f"[{tag}] maskige {n_mask} files, resize_frames {n_img}: "
                                 f"{rgb.shape}, {frame.shape}, {label.shape}")
        out["images"] = {"maskiges": n_mask, "resized": n_img, "wall_s": tools_s}
        log(f"[{tag}] maskige: {n_mask} Maskiges {rgb.shape}; resize_frames --mode crop: "
            f"{n_img} frames and labels at {SIZE}^2, read back; {tools_s:.2f} s wall")
    check_imports(f"[{tag}] the tools")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only (build, each kernel against its plain version, "
                         "timings), for comparing two trees; prints no status line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        return out

    smi = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    ps = phase_point_sample(dev)
    k7 = phase_k7(dev)
    k6 = phase_k6(dev)
    mc = phase_match_cost(dev, smi)
    with_library = ([(s["name"], s) for s in ps["fwd"]]
                    + [("k4_dimg", ps["dimg"]), ("k4_dxy", ps["dxy"]), ("k6", k6)])
    if args.kernels_only:
        rank_against_library(with_library)
        log(f"[kernels-only] done on {smi}")
        return 0

    from combo_avs_torch.models.layers import init_weights
    from combo_avs_torch.models.meta_arch import MaskFormer

    walls["kernels"] = time.perf_counter() - t_start
    jp = timed("jpeg", phase_jpeg, smi)
    t0 = time.perf_counter()
    model = init_weights(MaskFormer(), seed=SEED)  # builds on the current CUDA device
    if next(model.parameters()).device != dev:
        raise AssertionError("MaskFormer() did not build on the card")
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] MaskFormer() COMBO-R50 S4: {n_params} parameters, seeded init on "
        f"{torch.cuda.get_device_name(0)} in {time.perf_counter() - t0:.1f} s")
    sl = timed("slice", phase_slice, model, smi)
    ee = timed("eval-entry", phase_eval_entry, model, smi)
    tta = timed("tta", phase_tta, model, smi)
    tr = timed("train", phase_train, model, smi)
    te = timed("train-entry", phase_train_entry, smi, tr["s_per_step"], R50_CONFIG)
    # the card-vs-CPU phases see the weights of the training steps above
    twin = cpu_twin(model, lambda d: MaskFormer(device=d))
    timed("card-vs-cpu", phase_card_vs_cpu, model, twin)
    timed("train-card-vs-cpu", phase_train_card_vs_cpu, model, twin)
    tf = timed("train-k6", phase_train_fallback, model)
    del model, twin
    torch.cuda.empty_cache()
    ddp = timed("ddp", phase_ddp, smi, dev)
    var = timed("variants", phase_variants, smi, dev)
    ve = timed("variant-entry", phase_variant_entry, smi)
    tools = timed("tools", phase_tools, smi, dev)
    avss = phase_avss(smi, dev, walls)
    pvt = phase_pvt(smi, dev, walls)

    ev, tl, fb, tn = sl["launches"], tr["launches"], tf["launches"], te["launches"]
    entry = {k: ee["fp32"]["launches"][k] + ee["bf16"]["launches"][k] for k in ev}
    paths = {"eval": ev, "eval_entry": entry, "train": tl, "train_entry": tn,
             "train_fallback": fb, "pvt_eval": pvt["slice"]["launches"],
             "pvt_train": pvt["train"]["launches"], "pvt_train_entry": pvt["entry"]["launches"],
             "pvt_pred_ms3": pvt["pred_ms3"]["launches"], "avss_train": avss["train"]["launches"],
             "avss_train_entry": avss["entry"]["launches"], "avss_pred": avss["pred"]["launches"],
             "tta_pred": tta["launches"]}
    for name, row in var.items():
        paths[f"variant_{name}_eval"] = row["eval_launches"]
        paths[f"variant_{name}_train"] = row["train_launches"]
    paths["variant_train_entry"] = ve["train_net"]["launches"]
    paths["variant_pred"] = ve["pred"]["launches"]
    for r in ddp["rows"]:
        paths[f"ddp_train_rank{r['rank']}"] = r["counts"]
        paths[f"ddp_eval_rank{r['rank']}"] = r["eval_counts"]
    ddp_plans = {f"ddp_{part}": [r[key] for r in ddp["rows"]]
                 for part, key in (("train", "plans"), ("eval", "eval_plans"))}

    def ddp_by_plan(k):
        """Kernel k's launches by plan on each rank of the ddp paths."""
        return {path: [plans[k] for plans in ranks] for path, ranks in ddp_plans.items()}

    def by_path(k):
        return {name: counts[k] for name, counts in paths.items()}

    fwd = ps["fwd"]
    per_layer = {k: sum(s[k] for s in fwd) for k in ("ms", "call_ms", "host_us", "plain_ms",
                                                     "library_ms", "library_call_ms",
                                                     "library_host_us", "bound_ms", "bytes",
                                                     "flops")}
    per_layer.update({k: "+".join(sorted({s[k] for s in fwd}))
                      for k in ("device_source", "library_source")})
    ranked = rank_against_library(with_library)
    walls["total"] = time.perf_counter() - t_start
    log("[wall] " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + f" on {smi}")
    kernels = [
        kernel_entry("ms_deform_attn_fwd", "combo_avs_torch/csrc/ms_deform_attn_fwd.cu",
                     REPLACES["k1"], by_path("k1"), k1["fp32"],
                     shape="value [20,1029,8,32] fp32", plan=k1["fp32"]["chosen"],
                     eval_launches_by_plan=sl["k1_plans"],
                     max_abs_err_bf16=k1["bf16"]["max_abs_err"],
                     ms_bf16=k1["bf16"]["ms"], call_ms_bf16=k1["bf16"]["call_ms"],
                     plain_ms_bf16=k1["bf16"]["plain_ms"], bound_ms_bf16=k1["bf16"]["bound_ms"],
                     ms_train=k1["train_fp32"]["ms"], bound_ms_train=k1["train_fp32"]["bound_ms"],
                     tta_launches_by_plan=tta["plans"]["k1"],
                     **{f"{k}_{name}": k1[name][k]
                        for name in ("tta384_bf16", "tta384_fp32")
                        for k in ("max_abs_err", "ms", "call_ms", "host_us", "plain_ms",
                                  "bound_ms", "bound_by")},
                     **{f"plan_{name}": k1[name]["plan"] for name in ("tta384_bf16",
                                                                       "tta384_fp32")},
                     plans_ms={name: {kn: v["ms"] for kn, v in k1[name]["plans"].items()}
                               for name in ("fp32", "bf16", "train_fp32", "train_bf16",
                                            "tta384_bf16", "tta384_fp32")},
                     ddp_launches_by_plan=ddp_by_plan("k1")),
        kernel_entry("ms_deform_attn_bwd", "combo_avs_torch/csrc/ms_deform_attn_bwd.cu",
                     REPLACES["k2"], {name: n for name, n in by_path("k2").items()
                                      if not name.startswith("avss")}, k2["level_slice"],
                     shape="value [40,1029,8,32] fp32", plan="level_slice",
                     ddp_launches_by_plan=ddp_by_plan("k2"),
                     **{f"global_{k}": k2["global"][k] for k in ("max_abs_err", "ms", "call_ms",
                                                                 "host_us", "device_source")}),
        kernel_entry("ms_deform_attn_bwd_bf16", "combo_avs_torch/csrc/ms_deform_attn_bwd.cu",
                     REPLACES["k2"], {name: paths[name]["k2"] for name in (
                         "avss_train", "avss_train_entry")}, k2["bf16"],
                     shape=f"value [{AVSS_N},1029,8,32] bf16 (grad, locations and weights bf16)",
                     plan="level_slice",
                     launches_by_type={"avss_train": avss["train"]["k2_dtypes"]}),
        kernel_entry("point_sample_fwd", "combo_avs_torch/csrc/point_sample_fwd.cu",
                     REPLACES["k3"], by_path("k3"),
                     dict(per_layer, max_abs_err=max(s["max_abs_err"] for s in fwd),
                          bound_by="bytes" if per_layer["bytes"] / PEAK_BYTES_PER_S
                          >= per_layer["flops"] / PEAK_FP32_PER_S else "operations"),
                     also_replaces=REPLACES["k5"],
                     shape="one decoder output's 5 calls, summed; each in calls",
                     calls=[{k: s[k] for k in ("name", "shape", "points", *TIMING_KEYS,
                                               "bound_ms", "bound_by", "max_abs_err")}
                            for s in fwd]),
        kernel_entry("point_sample_bwd_dimg", "combo_avs_torch/csrc/point_sample_bwd.cu",
                     REPLACES["k4"], by_path("k4_dimg"), ps["dimg"],
                     shape="dout [120,12544,1] into [120,56,56,1]", plan="staged",
                     train_launches_by_plan=tr["dimg_plans"],
                     ddp_launches_by_plan=ddp_by_plan("k4_dimg"),
                     plan_detail=ps["dimg"]["plan"],
                     **{f"global_{k}": ps["dimg"]["global_plan"][k]
                        for k in ("max_abs_err", "ms", "call_ms", "host_us", "device_source")},
                     also_replaces=REPLACES["k4_dxy"],
                     dxy_launches=by_path("k4_dxy"),
                     **{f"dxy_{k}": ps["dxy"][k] for k in ("max_abs_err", *TIMING_KEYS,
                                                           "bound_ms", "bound_by")}),
        kernel_entry("seminf_fwd", "combo_avs_torch/csrc/seminf_fwd.cu", REPLACES["k7"],
                     by_path("k7"), k7["fp32"],
                     shape="mask [20,100,56,56] fp32 -> [20,2,224,224]", plan="patch",
                     plan_detail=k7["fp32"]["plan"], eval_launches_by_plan=sl["k7_plans"],
                     ddp_launches_by_plan=ddp_by_plan("k7"),
                     resize_ms=k7["fp32"]["resize_ms"],
                     resize_call_ms=k7["fp32"]["resize_call_ms"],
                     max_abs_err_bf16=k7["bf16"]["max_abs_err"], ms_bf16=k7["bf16"]["ms"],
                     call_ms_bf16=k7["bf16"]["call_ms"], plain_ms_bf16=k7["bf16"]["plain_ms"],
                     resize_ms_bf16=k7["bf16"]["resize_ms"], bound_ms_bf16=k7["bf16"]["bound_ms"],
                     tta_launches_by_plan=tta["plans"]["k7"],
                     **{f"{k}_tta384_bf16": k7["tta384_bf16"][k]
                        for k in ("max_abs_err", "ms", "call_ms", "host_us", "plain_ms",
                                  "bound_ms", "bound_by")},
                     **{f"pixel_{k}{sfx}": k7[name]["pixel_plan"][k]
                        for name, sfx in (("fp32", ""), ("bf16", "_bf16"))
                        for k in ("max_abs_err", "ms", "call_ms", "host_us")}),
        kernel_entry("gather_points", "combo_avs_torch/csrc/gather.cu", REPLACES["k6"],
                     by_path("k6"), k6,
                     shape="src [120,37632,2] fp32, idx [120,9408] int64",
                     points_per_thread=k6["points_per_thread"], floors_ms=k6["floors"]),
        kernel_entry("match_cost", "combo_avs_torch/csrc/match_cost.cu",
                     REPLACES["k5"] + " fused with the matcher's cost sums", by_path("match_cost"),
                     mc["cells"], shape=f"masks [{TRAIN_N},100,56,56] at 12544 points, K = 3",
                     plan=mc["cells"]["plan"],
                     **{f"{k}_avss": mc["avss"][k] for k in ("max_abs_err", "ms", "call_ms",
                                                             "host_us", "bound_ms", "bound_by",
                                                             "plain_ms", "plain_device_ms",
                                                             "path_ms", "path_call_ms")}),
    ]
    log(json.dumps({"train": {"s_per_step": tr["s_per_step"], "step_times_s": tr["times"],
                              "max_memory_allocated": tr["peak_bytes"],
                              "shape": f"{TRAIN_B}x{T}x{SIZE}^2 K={TRAIN_K} fp32"},
                    "train_entry": {"s_per_iter_median": te["s_per_iter_median"],
                                    "data_time_median": te["data_time_median"],
                                    "rows": te["first"]["rows"] + te["resumed"]["rows"],
                                    "evals": te["first"]["evals"],
                                    "eval_timing": te["first"]["eval_timing"]},
                    "eval_fps": sl["fps"], "card": smi,
                    "slower_than_library": [r[0] for r in ranked if r[3] > 1],
                    "eval_entry": {k: {"metrics": v["metrics"], "timing": v["timing"]}
                                   for k, v in ee.items()},
                    "jpeg": jp, "tta": {k: v for k, v in tta.items() if k != "launches"},
                    "avss": avss["summary"], "pvt": pvt["summary"],
                    "ddp": {"ranks": [{k: r[k] for k in ("rank", "world", "s_per_step",
                                                         "allreduce_s", "grad_bytes", "trainable",
                                                         "peak_bytes", "metrics",
                                                         "eval_metrics")}
                                      for r in ddp["rows"]],
                            **{k: ddp[k] for k in ("steps", "eval_max_diff",
                                                   "ranks_wall_s", "entry_wall_s", "entry_cards",
                                                   "entry_metrics")}},
                    "variants": {name: {k: row[k] for k in (
                        "params", "eval_s", "train_s", "peak_bytes", "optimizer", "n_cosine",
                        "losses", "card_vs_cpu") if k in row} for name, row in var.items()},
                    "variant_entry": {"train_net": {k: ve["train_net"][k] for k in (
                        "wall_s", "rows", "evals")}, "pred": {k: ve["pred"][k] for k in (
                            "wall_s", "metrics")}},
                    "tools": tools,
                    "walls_s": walls}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
