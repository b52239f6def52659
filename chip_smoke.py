#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. print the card's name and power limit (``nvidia-smi``); no CUDA device -> exit 1;
2. build the kernel libraries from ``metrics_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel, with ``g++`` for the host RLE codec) and print what
   ``ptxas`` reports for each kernel (registers, spills, shared memory);
3. hold each kernel against its plain PyTorch version on the card: the binned
   counts in both input modes ((N, C) targets and mask; (N,) labels)
   integer-equal, in float32 and in float64 (scores on the float64 grid and
   within half a float32 ulp of it), the SSIM window within
   ``SSIM_RTOL``/``SSIM_ATOL``, MS-SSIM's planes at every scale of a DIV2K
   image, a plane smaller than one 64 x 64 tile, VIF's 17-, 9-, 5- and 3-tap
   gaussian windows and the 8- and 7-tap uniform windows among its shapes;
4. the main path through the public classes on ``device="cuda"``, each result
   checked against the same inputs run through the port on the CPU; every
   kernel's launch count is set to 0 just before each metric's run and read
   just after, so the run shows which kernel each metric went through (the
   multiclass curve through the labels mode). Its metrics: accuracy, the
   binary and multiclass PR curves, SSIM, then the binned curve family:
   multilabel mAP over the 80 MS-COCO labels, binary and multiclass AUROC,
   the exact binary AUROC below a ``max_fpr``, and every curve class through
   its task wrapper for each task; then the stat-score and confusion-matrix
   family, which launches no kernel: an ImageNet-1k evaluation (1000 classes,
   the 50,000 validation images in 5 updates of 10,000: precision, recall,
   F1, the confusion matrix, Matthews, Jaccard, top-5 precision and the
   15-bin ECE), F1, Hamming, exact match and the three ranking metrics on the
   COCO-80 multilabel inputs, quadratic-weighted kappa over 5 grades, a
   float64 binary AUROC under torch's float64 default (the float64 binned
   counts), and every new class through its task wrapper for each task; then
   the collection, aggregation and sync layer: the ImageNet-1k evaluation as
   one ``MetricCollection`` (its compute groups, beside a ``MeanMetric`` of the
   cross-entropy, a ``SumMetric`` of the samples and a ``CatMetric`` of the
   arg-max predictions), multilabel AP and AUROC over the COCO-80 inputs in one
   collection (one compute group: one binned-counts launch per update with the
   group given, four in three updates when detected), MSE, MAE, Pearson and
   Spearman over 2^22 samples with RMSE as ``MeanSquaredError() ** 0.5`` and the
   ImageNet collection driven through ``functional()``, group fairness over the
   five race groups of the UCI Adult census data on 2^20 rows, the NCCL sync in
   a process group of one (and what gloo does with CUDA tensors), two
   processes on the one card syncing CUDA tensors through gloo, and four
   ranks' states folded on the card by ``allreduce_over_mesh`` against the
   single stream; then the checks that end the JAX package's multi-chip dryrun,
   which launch no kernel: retrieval at MS MARCO dev scale (6,980 queries x
   1,000 candidates; MRR@10, NDCG@10, MAP and Recall@100 in one collection),
   ``compute_flat`` over four ranks' shards and four ranks' NDCG states folded;
   ``MeanAveragePrecision`` at COCO val2017 scale (5,000 images, 80 classes,
   100 detections an image) with the IoU and GIoU metrics on the same boxes,
   and four ranks' per-image states flattened, folded and split back;
   ``BootStrapper`` (20 copies) over the ImageNet-1k evaluation and its copies
   folded from four ranks against ``merge_state``; and four processes on the
   card in a (model 2, data 2) gloo layout, each syncing over its data row's
   ``dist.new_group``; then the image and segmentation paths: PSNR, SSIM and
   MS-SSIM in one collection over 100 DIV2K-sized pairs (3 x 1356 x 2040, one
   window launch an update for SSIM and five for MS-SSIM, read per metric),
   3-D SSIM over BraTS-sized volumes (4 x 155 x 240 x 240, no kernel), bbox
   and mask MAP over 500 COCO val2017-like images at a synthetic mix of sizes
   640 pixels on the long side (the RLE states equal to the CPU run's, the
   compute's stages, the mask IoUs' device time and peak memory) and panoptic quality over 5,000 COCO panoptic-sized
   label maps (133 categories); each against the port's CPU run of a stated
   subset; then the rest of regression and the wrappers on it: the twelve new
   scalar classes with MSE, MAE, Pearson and Spearman in one collection over
   2^22 log-normal targets (explained variance, NRMSE, concordance and R2
   also join the regression path above, its NCCL sync and its four-rank
   fan-in), ``MultioutputWrapper`` over R2 and MAE at QM9's 130,831 molecules
   x 12 targets (and with 1 % NaN targets), Kendall tau b and c of 65,536 WMT-
   sized (score, rating) pairs against scipy, CSI at VIL 74 and 133 over 256
   SEVIR-sized sequences (12 x 384 x 384), KL divergence of ImageNet-1k
   softmax outputs, cosine similarity of 50,000 BERT-base-wide pairs; per-class
   COCO-80 AP (one binned-counts launch an update) and ImageNet accuracy
   through ``ClasswiseWrapper``, both input transformers around the binary
   AUROC (one launch an update each), ``MetricTracker`` over the ImageNet
   collection, ``MinMaxMetric`` and ``MultitaskWrapper``; then the rest of
   image and segmentation: pansharpening at WorldView-3 size (UQI, SAM, ERGAS,
   RASE, RMSE-SW and SCC in one collection over 20 reduced-resolution images of
   8 x 256 x 256; D_lambda, D_s and QNR over 20 full-resolution images of 8 x
   512 x 512 with their MS and PAN), VIF over 200 LIVE-sized pairs (3 x 512 x
   768), PSNR-B over 100 JPEG-blocked 512 x 512 images, total variation and
   image gradients over the 100 DIV2K-sized images, mean IoU, Dice and
   generalized Dice over 100 Cityscapes-sized label maps (1024 x 2048, 19
   classes) and the Hausdorff distance over 10 of those maps and 3 BraTS-sized
   volumes (155 x 240 x 240, 4 labels); each window metric's launches read
   around its compute; then pairwise, clustering, nominal and shape, which
   launch no kernel: cosine, euclidean and linear similarity of CIFAR-10's
   10,000 test against its 50,000 train embeddings at ResNet-18 width (512)
   with every reduction, manhattan and Minkowski distances in row blocks, the
   nine label clustering metrics over ImageNet-1k's 1,281,167 train labels
   against 1,000 clusters (AMI's expected mutual information over about 1.3e9
   terms on the card), Calinski-Harabasz, Davies-Bouldin and Dunn over 50,000
   ResNet-50-wide embeddings with 1,000 labels, the four nominal ``*_matrix``
   functions over 2^20 rows of UCI Adult's nine categorical columns (1 % NaN,
   both ``nan_strategy``s) and the four classes on (occupation, income),
   Fleiss' kappa at CIFAR-10H size in both modes, Procrustes disparity over
   2^17 Human3.6M-sized poses (and the host syncs of ``torch.linalg.svd``);
   then ``to_device`` card -> CPU -> card mid-stream, ``state_fingerprint``
   across devices, the forward-state check on the card and ``plot()`` (it
   raises the JAX package's error where matplotlib is not installed); then the
   streaming family, which launches no kernel: a Criteo-sized click stream
   (45,840,617 rows in updates of 2^20) through StreamingAUROC,
   StreamingCalibrationError, HyperLogLog of a Zipf id column and
   ReservoirSample, CUSUM on its per-update click rate, DDSketch over 2^26
   request latencies, PSI and KS of the 13 integer features, one hour of
   timestamped updates through TimeDecayed (plain and compensated),
   TumblingWindow, DecayedDDSketch and DecayedHLL, and MetricLogbook over two
   ImageNet-1k epochs; each against the port's CPU run of a stated subset, its
   four shards merged on the card against the single stream, and exact
   answers where they exist; a later sketch or drift update that synchronizes
   with the host fails the run; then text and audio without models
   (``text_and_audio``); last, ``observe_and_durability``, whose launches are
   counted apart from the main path's: the ImageNet-1k and COCO-80 collections
   under ``observe.scope()`` (update counts, the timeline, host syncs equal with
   telemetry off and on, the profiler range around the binned-counts launch,
   p50/p99, a flagship update's host ms off and on), input guards (states
   bit-equal after a NaN batch, no added host sync, ``raise_on_host``),
   checkpoints saved from the card and restored on the card and on the CPU with
   equal fingerprints (the two collections and a 200 MB cat state; MB and MB/s),
   a flipped byte, another config, the periodic checkpointer, the exact AUROC and
   MAP over 5,000 COCO images refused on restore as in the JAX package, and a
   watchdog rule on the update p99 that fires and resolves; then
   ``fleet_engine``, its launches also counted apart, at the JAX package's
   benchmark fleet sizes (``bench.py:62-80``): 10,000 and 1,000 streams of
   MulticlassAccuracy and BinaryAUROC through the StreamEngine (one dispatch
   and one binned-counts launch a tick, launches and host syncs a tick equal
   at both sizes, no new program through the churn, no compute dispatch a
   poll, sampled sessions bit-equal to per-instance oracles on the card, the
   1,000-stream fleet's states equal to a CPU engine's), 512 SSIM monitors
   (one window launch of 7,680 planes a tick), 1,000 multiclass AUROC
   sessions, the 1,000-stream fleet's recovery (checkpoint, a journaled wave
   lost with the process, restore on the card bit-exact and on the CPU
   equal), 25,000 two-scalar sessions over 8 shards (one dispatch a shard
   tick, a shard healed from its own files, an 8 -> 12 resize) and
   BootStrapper's 20 copies over the ImageNet-1k evaluation through the
   replica engine against its loop; then ``serve``, launches counted apart:
   10,000 and 1,000 streams served over TCP from two producer processes into
   a StreamEngine on the card (frames a second, ack latency, fsyncs a poll
   batch; one dispatch and one binned-counts launch a tick, host syncs a tick
   equal at both sizes, sampled sessions bit-equal to oracles), a ``kill -9``
   of a child server on the card mid-stream and its restart from the journal
   (no acked record lost, states bit-equal to an oracle fed each record once),
   the JAX package's overload soak (double, demote and shed all fire;
   survivors bit-equal to never-shed oracles), 8 shards behind the server
   with a resize on imbalance, refused torch-global frames and JAX-package
   metric blobs, and ``run_serve_smoke()``; then ``model_based``: FID, KID,
   IS and MiFID in one ``FeatureShare`` over the FID InceptionV3 at CIFAR-10's
   size (20,000 images resized to 299, one forward a batch), LPIPS through
   VGG16, AlexNet and SqueezeNet over 10,000 BAPPS-sized pairs, and PPL over
   a small generator, each against the port's CPU run of a subset; then
   ``model_based_text_multimodal``, launches counted apart, through synthetic
   encoders computed on the card (no weights exist): BERTScore over WMT14
   newstest2014's 3,003 pairs at roberta-large's 1,024-d token embeddings
   (reference token counts drawn over 10-60), InfoLM with each of its nine
   measures over the same pairs' distributions on bert-base-uncased's 30,522
   words, CLIPScore and CLIP-IQA with all 16 prompts over MS-COCO val2017's
   5,000 images (3 x 224 x 224) with one caption each at ViT-L/14's 768-d
   projection, each against the port's CPU run of a stated subset (compute ms,
   peak MB), then the default paths, ``load_clip`` and ``load_text_encoder``
   over random checkpoints of ViT-L/14's and roberta-large's published widths
   saved with hand-written vocabularies (images/s, pairs/s); last
   ``observe_costs``, launches counted apart: the telemetry overhead budget with
   its step loop on the card, every ``PROFILE_CASES`` class profiled on the
   card with ``flops`` and ``bytes_accessed`` equal to the committed CPU
   baseline, each case's peak memory, and the binned-counts and window launches
   of the thresholded AUROC/AP, SSIM and UQI cases; then
   ``analysis_contracts``, launches counted apart: every transfer case under
   ``set_sync_debug_mode("error")`` with its verdict equal to the CPU
   dispatch-mode prediction (and the binned curves and SSIM at the main path's
   shapes), a fleet tick at 100 sessions and at 10,000 streams and a sharded
   churn tick with no sync outside ``_transfer_scope``, the 73 merge
   classifications equal to the CPU's, the precision registry and its five
   regimes, every bucketable class through a churning CUDA bucket (B1/B2
   launched through the ``vmap`` rules), the chaos metric and fleet suites over
   the kernel classes and ``BinaryAccuracy``, jitlint, distlint, donlint and
   racelint over the port's source clean against their baselines, every
   functional kernel traced on fake CUDA tensors to its fake CPU trace's shapes,
   every jit-eligible class's donation lifecycle on the card with the CPU's
   verdicts (B1/B2 launched), 1,100 interleaving schedules of the served engine
   with its sessions on the card, and the kernel-library cache (a cold build
   into an empty directory in one process, then the aot contract over the
   registry against it with no build of its own, ``ROUNDTRIP`` for every class
   that launches B1 or B2; nothing built in the next);
5. time each kernel, its plain version and (for the window) one library call
   with CUDA events at the main path's shapes (the window also at the DIV2K
   first scale, VIF's 17-tap window at the LIVE size and the 8-tap uniform
   window at SCC's WorldView-3 planes; the binned counts at the fleet's fold, 16 x 8,192 columns x 16
   thresholds, and at the served 1,000-stream fold, 16 x 1,024 x 16, and the window at the SSIM bucket's
   7,680 planes), beside the least time the card could
   take (``bound_ms``); then one MS-SSIM update of a DIV2K pair, whole and
   scale by scale, and the window at each VIF scale's two launches. With ``--baseline DIR`` (an unpacked older tree of
   this repository) the older kernels are timed in turns with these, old, new,
   new, old, each old run in a process of its own started in ``DIR``;
6. print the kernels' JSON line and, last, the device JSON line.

Inputs come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SSIM_RTOL, SSIM_ATOL = 1e-5, 1e-6  # window sums of values in [0, 1]; the kernel keeps the plain order of roundings
ACC_BATCH, ACC_CLASSES, ACC_STEPS = 1 << 20, 10, 50
PRC_THRESHOLDS, BIN_N, MC_N, PRC_STEPS = 200, 1 << 22, 1 << 20, 3
SSIM_SHAPE, SSIM_STEPS = (20, 3, 256, 256), 3
# multilabel mAP over the 80 MS-COCO labels (the usual score of multilabel image classifiers); 2^18 images per
# update, about 6.5 COCO val2014 sets; about 2.9 of the 80 labels are present per image (3.6 %)
ML_N, ML_LABELS, ML_POSITIVE = 1 << 18, 80, 0.036
EXACT_N, WRAPPED_N = 1 << 20, 1 << 16
CURVE_RTOL, CURVE_ATOL = 1e-5, 1e-6  # float32 sums of up to T + 1 trapezoids or steps, in another order
# ImageNet-1k evaluation: the 50,000 validation images in 5 updates of 10,000 x 1000 float32 logits, about
# 75 % of them right at top-1
IN_CLASSES, IN_BATCH, IN_STEPS, IN_TOP1 = 1000, 10_000, 5, 0.75
KAPPA_N, KAPPA_GRADES = 1 << 16, 5  # quadratic-weighted kappa over 5 grades (diabetic-retinopathy grading)
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6  # scores from equal counters, reduced on the card in another order
SUM_RTOL, SUM_ATOL = 1e-4, 1e-6  # ECE and hinge: float sums over 10^4-10^5 samples in another order
REG_N, REG_STEPS = 1 << 20, 4  # regression: 2^22 float32 samples in 4 updates
CORR_RTOL = 1e-4  # Pearson and Spearman, as the JAX package's multi-chip dryrun holds them
FOLD_RTOL = 1e-5  # float scores and sums folded from four ranks against the single stream
# group fairness over the five race groups of the UCI Adult census data (White, Black, Asian-Pac-Islander,
# Amer-Indian-Eskimo, Other, in the data's proportions); 2^20 rows, about 21 Adult sets, in 4 updates
FAIR_N, FAIR_STEPS, FAIR_GROUPS = 1 << 18, 4, [0.854, 0.096, 0.031, 0.010, 0.009]
# MS MARCO passage ranking, the small dev set: 6,980 queries x 1,000 BM25 candidates in 10 updates; about 1.07
# judged passages per query, among the candidates for 86 % of the queries
RET_QUERIES, RET_CANDIDATES, RET_STEPS, RET_RECALL = 6980, 1000, 10, 0.86
RET_RTOL = 1e-5  # float32 sums over the 6,980 queries, taken in another order
# COCO val2017 boxes: 5,000 images, 80 classes, about 7.4 ground truths and 100 detections per image, 10 updates
COCO_IMAGES, COCO_CLASSES, COCO_GT_MEAN, COCO_DETS, COCO_STEPS = 5000, 80, 7.4, 100, 10
MAP_RTOL = 1e-6  # as the JAX package's dryrun holds MAP: float32 matching with the same decisions, float64 sums
IOU_RTOL = 1e-5  # float32 sums of about 10^5 IoUs, taken in another order
IOU_CPU_IMAGES = 1000  # the IoU and GIoU metrics' CPU check covers the first 1,000 of the 5,000 images
BOOT_COPIES, BOOT_RTOL = 20, 1e-6  # BootStrapper: the copies' scores are quotients of equal counters
# their float32 std: 20 scores near 0.75 that spread by about 0.003, so the deviations from the mean, summed
# in another order on the card, keep about 5 significant digits
BOOT_STD_RTOL = 1e-4
SUBGROUP_ROWS = 1 << 20  # labels per data shard in the subgroup sync
# super-resolution evaluation at DIV2K validation scale: the 100 validation pairs, 3 x 1356 x 2040 (DIV2K's HR
# images are 2040 pixels on the long side), one image an update; MS-SSIM makes one window launch per scale
DIV2K_IMAGES, DIV2K_SHAPE, DIV2K_CPU_IMAGES, MS_SSIM_SCALES = 100, (1356, 2040), 2, 5
PSNR_RTOL = 1e-5  # float32 sums of 8.3 M squared errors an image, taken in another order
SSIM_VALUE_ATOL = 1e-5  # SSIM and MS-SSIM values, as the CPU tests hold them against the JAX package
# 3-D SSIM at BraTS volume size: the four MRI modalities x 155 x 240 x 240, one volume an update; the CPU check
# covers the first 32 slices of the first volume at full height and width (the whole volume takes the CPU 7-14 s)
BRATS_VOLUMES, BRATS_SHAPE, BRATS_CPU_DEPTH = 3, (155, 240, 240), 32
# mask MAP on the first 500 of the 5,000 COCO val2017 images (the cut: the host's RLE encoding and the CPU
# check's dense masks set the time), 100 detections an image, in updates of 50
SEGM_IMAGES, SEGM_PER_UPDATE = 500, 50
# COCO panoptic val2017: 5,000 images of 480 x 640, 133 categories (80 things, 53 stuffs), updates of 50
PQ_IMAGES, PQ_PER_UPDATE, PQ_CPU_IMAGES, PQ_SHAPE, PQ_THINGS, PQ_STUFFS = 5000, 50, 50, (480, 640), 80, 53
PQ_RTOL = 1e-6  # iou_sum: float64 sums per update, the same on both devices, met by the float32 state once
# scalar regression: 2^22 log-normal targets (demand, sale prices), in updates of 2^18
REG_ALL_N, REG_UPDATE = 1 << 22, 1 << 18
# QM9 after the standard filtering: 130,831 molecules, MoleculeNet's 12 regression targets; updates of 4,096;
# the missing-label run sets 1 % of the targets to NaN
QM9_MOLECULES, QM9_TARGETS, QM9_UPDATE, QM9_NAN = 130_831, 12, 4096, 0.01
# WMT segment-level: 65,536 (metric score, human rating) pairs, ratings on the 0-100 grid; the CPU check covers
# the first 8,192; tau against scipy within 1e-6
KENDALL_N, KENDALL_UPDATE, KENDALL_CPU_N, KENDALL_ATOL = 65_536, 8192, 8192, 1e-6
# SEVIR nowcasts: VIL frames of 384 x 384, 12 predicted frames a sequence, 256 sequences in updates of 8; CSI
# at the VIL thresholds 74 and 133; the CPU check covers the first 32 sequences
SEVIR_FRAME, SEVIR_LEAD, SEVIR_SEQS, SEVIR_UPDATE, SEVIR_CPU_SEQS = 384, 12, 256, 8, 32
SEVIR_THRESHOLDS = (74.0, 133.0)
# sentence embeddings: 50,000 pairs of BERT-base width (768), updates of 10,000
EMB_N, EMB_DIM, EMB_UPDATE = 50_000, 768, 10_000
TRACK_EPOCHS, TRACK_UPDATES = 3, 2  # MetricTracker over the ImageNet collection
# pansharpening at WorldView-3 size, as PanCollection's test sets give it: 8 bands, ratio 4; 20 images each at
# reduced resolution (fused and reference 8 x 256 x 256) and at full resolution (fused 8 x 512 x 512, MS 8 x 128
# x 128, PAN 512 x 512 repeated over the bands), updates of 4; the CPU check covers the first 2 of each set
WV3_BANDS, WV3_RATIO, WV3_IMAGES, WV3_UPDATE, WV3_CPU_IMAGES = 8, 4, 20, 4, 2
WV3_REDUCED, WV3_FULL = 256, 512
# VIF at LIVE IQA size: 200 pairs of 3 x 512 x 768 (LIVE's reference images are at most 768 wide), updates of
# 20, blurred or noisy; the CPU check covers the first 4
LIVE_PAIRS, LIVE_SHAPE, LIVE_UPDATE, LIVE_CPU_PAIRS = 200, (512, 768), 20, 4
VIF_SCALES = 4  # taps 17, 9, 5, 3
# PSNR-B on JPEG deblocking: 100 grayscale 512 x 512 images with 8 x 8 blocking, updates of 10; CPU: the first 10
JPEG_IMAGES, JPEG_SIZE, JPEG_UPDATE, JPEG_CPU_IMAGES, JPEG_STEP = 100, 512, 10, 10, 16.0
TV_UPDATE = 4  # total variation over the DIV2K-sized images, updates of 4; the CPU check covers the first 2
# Cityscapes val: 500 label maps of 1024 x 2048 (this run takes 100), 19 classes, void 255, updates of 4; the CPU
# check covers the first update's 4 maps; Hausdorff takes 10 maps, its CPU check a 256 x 512 crop of the first
CITY_MAPS, CITY_SHAPE, CITY_CLASSES, CITY_UPDATE, CITY_HD_MAPS, CITY_CROP = 100, (1024, 2048), 19, 4, 10, (256, 512)
# Hausdorff at BraTS size: 3 volumes of 155 x 240 x 240, labels 0-3 (background, necrotic core, edema,
# enhancing tumour); the CPU check a 40 x 96 x 96 crop through the first volume's tumour
BRATS_HD_VOLUMES, BRATS_HD_CROP = 3, (40, 96, 96)
IMAGE_RTOL = 1e-5  # image scores of sums over whole batches, taken in another order on the card
WINDOW_VALUE_ATOL = 1e-5  # UQI, SCC and RMSE-SW values, as the CPU tests hold them against the JAX package
VIF_RTOL = 1e-4  # VIF's log10 sums over whole maps, as the CPU tests hold it
SEG_RTOL = 1e-6  # segmentation scores from equal counts, reduced on the card in another order
# CIFAR-10 k-NN evaluation: the 10,000 test against the 50,000 train embeddings of ResNet-18 width (512), 10
# classes; the p-norm distances take the test embeddings against themselves; the CPU check covers the first
# 1,000 test against the first 5,000 train (or test) embeddings
KNN_TEST, KNN_TRAIN, KNN_DIM, KNN_CLASSES, KNN_CPU = 10_000, 50_000, 512, 10, (1000, 5000)
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-5  # as the CPU tests hold the pairwise functions against the JAX package
# cluster evaluation on ImageNet-1k (SCAN, DeepCluster): the 1,281,167 train labels against 1,000 clusters, in
# updates of 2^17; the CPU check runs the 50,000-image validation scale on the same 1,000 x 1,000 vocabulary
IN_TRAIN, IN_VAL, CLUSTER_UPDATE = 1_281_167, 50_000, 1 << 17
LABEL_RTOL, AMI_RTOL = 1e-6, 1e-5  # float32 sums over the table in another order; AMI: float64 EMI sums too
# ResNet-50 pooled embeddings (2048) of 50,000 images with 1,000 cluster labels, updates of 10,000; the CPU
# check: 5,000 embeddings with 100 labels
EMBED_N, EMBED_DIM, EMBED_K, EMBED_UPDATE, EMBED_CPU_N, EMBED_CPU_K = 50_000, 2048, 1000, 10_000, 5000, 100
INTRINSIC_RTOL = 1e-5
# UCI Adult's nine categorical columns at their cardinalities, 2^20 rows (about 21 Adult sets) in updates of
# 2^18, 1 % of the cells NaN; the CPU check covers the first 2^16 rows
ADULT_CARDS = {"workclass": 9, "education": 16, "marital-status": 7, "occupation": 15, "relationship": 6,
               "race": 5, "sex": 2, "native-country": 42, "income": 2}
ADULT_ROWS, ADULT_UPDATE, ADULT_CPU_ROWS, ADULT_NAN = 1 << 20, 1 << 18, 1 << 16, 0.01
NOMINAL_RTOL, NOMINAL_ATOL = 1e-6, 1e-6  # as the CPU tests hold them: differences of order-1 float32 values
# CIFAR-10H: the 10,000 CIFAR-10 test images, 10 classes, 50 human ratings each; probs mode in updates of 1,000
C10H_IMAGES, C10H_CLASSES, C10H_RATERS, C10H_UPDATE = 10_000, 10, 50, 1000
# a Human3.6M-sized pose evaluation (PA-MPJPE's alignment): 2^17 poses of 17 joints x 3 in updates of 1,024,
# one pose in 64 degenerate (every joint at one point); the CPU check covers the first 4,096
POSE_N, POSE_JOINTS, POSE_UPDATE, POSE_CPU_N, POSE_DEGENERATE_EVERY = 1 << 17, 17, 1024, 4096, 64
PROCRUSTES_RTOL, ROTATION_ATOL = 1e-5, 1e-5
# Criteo's display-advertising challenge (Kaggle) train set: 45,840,617 rows with 13 integer and 26 categorical
# features and a 25.6 % click rate, in updates of 2^20 rows; one categorical column's ids Zipf-distributed
# (exponent 1 over 10^8 ranks: about 1.0e7 distinct values in the stream); a logit level shift from update 30
CRITEO_ROWS, CRITEO_UPDATE, CRITEO_INT_FEATURES, CRITEO_ZIPF_RANKS = 45_840_617, 1 << 20, 13, 10**8
CRITEO_LOGIT_MU, CRITEO_LOGIT_SD, CRITEO_SCORE_NOISE, CRITEO_SHIFT_AT, CRITEO_SHIFT = -1.3, 1.2, 0.6, 30, 0.1
CRITEO_AUROC_BINS, CRITEO_ECE_BINS, CRITEO_HLL_P, CRITEO_RESERVOIR, CRITEO_EXACT_ROWS = 2048, 15, 14, 10_000, 1 << 22
CUSUM_K, CUSUM_H = 0.005, 0.02  # per-update click-rate deviation: half the shift to detect, and the alarm level
# request latencies: 2^26 log-normal values (median 50 ms) in updates of 2^20, 1 % exact zeros, 0.1 % non-finite
LATENCY_N, LATENCY_ZEROS, LATENCY_NONFINITE, LATENCY_ALPHA = 1 << 26, 0.01, 0.001, 0.01
LATENCY_QUANTILES = (0.5, 0.9, 0.99, 0.999)
# feature drift: PSI and KS of Criteo's 13 integer features, one day (a seventh of the rows) of reference against
# one live day in updates of 2^20, 64 bins; the live day's mean shifted by 0.6 sigma on 3 features
DRIFT_DAY_ROWS, DRIFT_BINS, DRIFT_SHIFTED, DRIFT_SHIFT_SD = 6_548_660, 64, (1, 4, 9), 0.6
# time windows: one hour of a service's events, one update a second of 4,096 events, 1 % of the updates late by up
# to two panes; half-life 300 s, 60 panes of 60 s; the CPU check covers the first 300 updates
WINDOW_SECONDS, WINDOW_EVENTS, WINDOW_LATE, WINDOW_HALF_LIFE = 3600, 4096, 0.01, 300.0
WINDOW_PANE_S, WINDOW_PANES, WINDOW_CPU_UPDATES = 60.0, 60, 300
SKETCH_SHARDS = 4  # each stream also split into four shards, merged with merge_state on the card
SKETCH_RTOL = 1e-6  # float sketch states (confidence sums, decayed states) against the CPU run of the same updates
MERGE_RTOL = 1e-5  # float sums regrouped by the shard merge: up to 44 float32 additions in another association
# LibriSpeech test-clean: 2,620 utterances of 20 words on average, from a 10,000-word vocabulary with Zipf
# frequencies; the hypotheses carry about 5 % substitutions, 1 % insertions and 1 % deletions; the character
# metrics (host DPs) take the first 500; updates of 131 utterances, the CPU check the first update
LIBRI_UTTS, LIBRI_WORDS, LIBRI_VOCAB, LIBRI_UPDATE, LIBRI_CER_UTTS = 2620, 20, 10_000, 131, 500
LIBRI_SUB, LIBRI_INS, LIBRI_DEL = 0.05, 0.01, 0.01
# WMT14 newstest2014 en-de: 3,003 segments of about 22 tokens with one reference, in updates of 273; EED over the
# first 200 pairs, TER over 8 pairs cut to 15 tokens (its shift search is host Python)
WMT_SEGS, WMT_TOKENS, WMT_UPDATE, WMT_EED_PAIRS, WMT_TER_PAIRS, WMT_TER_TOKENS = 3003, 22, 273, 200, 8, 15
# CNN/DailyMail test: summaries of 3-4 sentences, about 55 words; 1,000 of them (of 11,490)
CNNDM_SUMMARIES = 1000
# SQuAD v1.1 dev: 10,570 questions with 1-3 reference answers each
SQUAD_QUESTIONS = 10_570
# WikiText-103 test in GPT-2 tokens: 30 updates of 8 x 1,024 positions x 50,257 float32 logits (246 K tokens),
# 1 % of the positions ignore_index -100; the CPU check: the first row of the first update
WIKI_UPDATES, WIKI_BATCH, WIKI_SEQ, WIKI_VOCAB, WIKI_IGNORE = 30, 8, 1024, 50_257, 0.01
# Libri2Mix test ("min", 8 kHz): 3,000 mixtures of 2 sources cropped to 4 s (32,000 samples), updates of 16;
# SDR with 512 taps; C-SI-SNR on 512-point STFTs (hop 128); Libri3Mix: 160 mixtures of 3 sources
MIX_N, MIX_SPK, MIX_LEN, MIX_UPDATE, MIX_FS, MIX_SDR_TAPS, MIX_NFFT = 3000, 2, 32_000, 16, 8000, 512, 512
MIX3_N = 160
# STOI and ESTOI: 200 utterances of 3 s at 16 kHz, speech-like bursts with a silent stretch, noise at 5 dB SNR,
# updates of 20; SRMR: 100 utterances of 4 s at 16 kHz, 23 cochlear filters, updates of 10
STOI_N, STOI_SECONDS, STOI_FS, STOI_UPDATE, STOI_SNR_DB = 200, 3.0, 16_000, 20, 5.0
SRMR_N, SRMR_SECONDS, SRMR_FS, SRMR_UPDATE = 100, 4.0, 16_000, 10
TEXT_SHARDS = 4  # the WER, BLEU and SI-SDR streams also in four shards, merged on the card
AUDIO_DB_ATOL, SDR_ATOL, STOI_ATOL, SRMR_RTOL, PPL_RTOL = 1e-4, 0.01, 1e-5, 1e-4, 1e-5
# the JAX package's error for a plot without matplotlib (``metrics_tpu/utils/plot.py``), which the port repeats
MATPLOTLIB_ERROR = "Plot function expects `matplotlib` to be installed. Please install with `pip install matplotlib`"
COCO_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat", "traffic light",
    "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote", "keyboard", "cell phone",
    "microwave", "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


SECTION_S: dict = {}  # wall seconds of each part of the main path, printed after it


def log(msg: str) -> None:
    print(msg, flush=True)


def section(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``SECTION_S[name]``."""
    t0 = time.perf_counter()
    result = fn(*args)
    SECTION_S[name] = time.perf_counter() - t0
    return result


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------- phase 3
def check_kernels(rng: np.random.Generator) -> dict:
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import (
        binned_counts,
        binned_counts_labels,
        binned_counts_labels_plain,
        binned_counts_plain,
    )
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    def binned_args(n, c, t):
        return [
            torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
            torch.from_numpy(rng.random((n, c)) > 0.1).cuda(),
            _adjust_threshold_arg(t, torch.device("cuda")),
        ]

    def labels_args(n, c, t):
        preds = rng.random((n, c), dtype=np.float32)
        preds[rng.random((n, c)) < 0.01] = np.nan
        labels = rng.integers(-1, c + 1, n, dtype=np.int32)  # -1 ignored, c out of range: a negative of every class
        return [torch.from_numpy(preds).cuda(), torch.from_numpy(labels).cuda(),
                _adjust_threshold_arg(t, torch.device("cuda"))]

    def compare(name, got, want, shape):
        err = 0
        for g, w in zip(got, want):
            err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                fail(f"{name} differs from its plain version at shape {shape}")
        return err

    nan, inf = float("nan"), float("inf")
    edge = [
        torch.tensor([[0.0], [0.25], [0.5], [0.5], [1.0], [nan], [0.75], [inf], [-inf]]).cuda(),
        torch.tensor([[0], [1], [1], [0], [1], [1], [1], [1], [0]], dtype=torch.int32).cuda(),
        torch.tensor([[True]] * 6 + [[False]] + [[True]] * 2).cuda(),
        torch.tensor([0.0, 0.25, 0.5, 0.5, 1.0, nan]).cuda(),
    ]
    # the shapes of tests/test_binned_hist_kernel.py, the edge cases, one whose classes are tiled over
    # blocks (too wide for one block's shared memory), the three full sizes (the multilabel one tiles its
    # 80 labels over two blocks too)
    shapes = [(100, 1, 5), (257, 3, 17), (1000, 4, 100), (50, 2, 129), (8, 1, 1), (4096, 300, 200),
              (BIN_N, 1, PRC_THRESHOLDS), (MC_N, 10, PRC_THRESHOLDS), (ML_N, ML_LABELS, PRC_THRESHOLDS)]
    binned_err = 0
    for args in [binned_args(*sh) for sh in shapes] + [edge]:
        binned_err = max(binned_err, compare("binned_counts", binned_counts(*args), binned_counts_plain(*args),
                                             tuple(args[0].shape)))
    labels_err = 0
    for sh in [sh for sh in shapes if sh[1] > 1]:
        args = labels_args(*sh)
        labels_err = max(labels_err, compare("binned_counts_labels", binned_counts_labels(*args),
                                             binned_counts_labels_plain(*args), sh))
    torch.cuda.synchronize()
    log(f"binned_counts: integer-equal to the plain version on {len(shapes) + 1} cases; labels mode on"
        f" {len([sh for sh in shapes if sh[1] > 1])}")

    # the float64 instantiation: scores on the float64 grid or within half a float32 ulp of it, compared in
    # float64 by the kernel and by its plain version (float64 searchsorted)
    f64_err = 0
    f64_shapes = [(100, 1, 5), (257, 3, 17), (50, 2, 129), (4096, 300, 200), (3000, 2, 20000),
                  (BIN_N, 1, PRC_THRESHOLDS), (MC_N, 10, PRC_THRESHOLDS), (ML_N, ML_LABELS, PRC_THRESHOLDS)]
    for n, c, t in f64_shapes:
        preds, grid = float64_near_grid(rng, (n, c), t)
        preds, grid = torch.from_numpy(preds).cuda(), torch.from_numpy(grid).cuda()
        target01 = torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda()
        valid = torch.from_numpy(rng.random((n, c)) > 0.1).cuda()
        f64_err = max(f64_err, compare("binned_counts[float64]", binned_counts(preds, target01, valid, grid),
                                       binned_counts_plain(preds, target01, valid, grid), (n, c, t)))
        if c > 1:
            labels = torch.from_numpy(rng.integers(-1, c + 1, n, dtype=np.int32)).cuda()
            f64_err = max(f64_err, compare("binned_counts_labels[float64]", binned_counts_labels(preds, labels, grid),
                                           binned_counts_labels_plain(preds, labels, grid), (n, c, t)))
    torch.cuda.synchronize()
    log(f"binned_counts float64: integer-equal to the plain version in both modes on {len(f64_shapes)} shapes")

    taps = _gaussian_taps_np(11, 1.5)
    ssim_err = 0.0
    # MS-SSIM's planes on a DIV2K image: 15 planes (5 moments x 3 channels) at each of the five scales, padded
    # by 10; the last two have odd padded widths (the kernel's 4-byte cp.async path); and a plane smaller than
    # one 64 x 64 tile, with an odd width
    div2k = [(5 * 3, (DIV2K_SHAPE[0] >> s) + 10, (DIV2K_SHAPE[1] >> s) + 10) for s in range(MS_SSIM_SCALES)]
    # the windows of UQI, VIF, SCC and the uniform filter: VIF's 17-tap gaussian (sigma 3.4) on its 512 x 768
    # planes, its 9, 5 and 3 taps (the last on planes under one tile), the 8- and 7-tap uniform windows on
    # 263 x 263 and 262 x 262 planes (a 256 x 256 image padded for them)
    uniform = {k: np.full(k, np.float32(1) / np.float32(k), dtype=np.float32) for k in (7, 8)}
    vif = {n: _gaussian_taps_np(n, n / 5.0) for n in (17, 9, 5, 3)}
    cases = [((12, 42, 74), taps, taps), ((6, 20, 40), taps, _gaussian_taps_np(5, 0.8)),
             ((5, 150, 203), taps, taps), ((70_000, 18, 18), taps, taps),
             ((5 * SSIM_SHAPE[0] * SSIM_SHAPE[1], SSIM_SHAPE[2] + 10, SSIM_SHAPE[3] + 10), taps, taps),
             *[(shape, taps, taps) for shape in div2k], ((15, 40, 51), taps, taps),
             ((20, *LIVE_SHAPE), vif[17], vif[17]), ((40, 256, 384), vif[9], vif[9]), ((40, 124, 188), vif[5], vif[5]),
             ((40, 61, 93), vif[3], vif[3]), ((7, 33, 47), vif[3], vif[3]),
             ((160, 263, 263), uniform[8], uniform[8]), ((160, 262, 262), uniform[7], uniform[7])]
    for shape, kh, kw in cases:
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
        got, want = ssim_window(x, kh, kw), ssim_window_plain(x, kh, kw)
        if not torch.allclose(got, want, rtol=SSIM_RTOL, atol=SSIM_ATOL):
            fail(f"ssim_window differs from its plain version at shape {shape} with {len(kh)} x {len(kw)} taps")
        ssim_err = max(ssim_err, float((got - want).abs().max()))
    torch.cuda.synchronize()
    log(f"ssim_window: allclose (rtol {SSIM_RTOL}, atol {SSIM_ATOL}) on {len(cases)} shapes, MS-SSIM's DIV2K planes"
        f" {div2k}, VIF's 17-, 9-, 5- and 3-tap and the 8- and 7-tap uniform windows among them; max |err| {ssim_err}")
    return {"binned_counts": float(binned_err), "binned_counts_labels": float(labels_err), "ssim_window": ssim_err,
            "binned_counts_f64": float(f64_err)}


def float64_near_grid(rng: np.random.Generator, shape, t: int):
    """float64 scores: a third uniform, a third on the float64 grid of ``t`` thresholds, a third within half a
    float32 ulp of it (above and below), and 1 % NaN; with that grid."""
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds

    grid = _linspace_thresholds(t, torch.float64)
    on = grid[rng.integers(0, t, shape)]
    near = on + rng.choice([-1.0, 1.0], shape) * np.spacing(on.astype(np.float32)).astype(np.float64) / 2 \
        * rng.uniform(0.1, 0.9, shape)
    which = rng.integers(0, 3, shape)
    preds = np.where(which == 0, rng.random(shape), np.where(which == 1, on, near))
    preds[rng.random(shape) < 0.01] = np.nan
    return preds, grid


# ----------------------------------------------------------------------------- phase 4
def _same_states(name, gpu, cpu, rtol=0.0, atol=0.0):
    """Counters integer-equal; the exact path's kept samples equal; float states (sums over samples, the
    calibration confidences after a softmax) within ``rtol``/``atol``."""
    for key in gpu.metric_state:
        a, b = getattr(gpu, key), getattr(cpu, key)
        a, b = (torch.cat([torch.atleast_1d(x) for x in a]), torch.cat([torch.atleast_1d(x) for x in b])) \
            if isinstance(a, list) else (a, b)
        a = a.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{name}: state {key} is {a.dtype} {tuple(a.shape)} on the card, {b.dtype} {tuple(b.shape)} on"
                 " the CPU")
        same = torch.equal(a, b) if not a.is_floating_point() or (rtol == 0 and atol == 0) \
            else torch.allclose(a, b, rtol=rtol, atol=atol)
        if not same:
            fail(f"{name}: state {key} on the card differs from the CPU run")


def main_path(seed: int, wrappers: dict) -> dict:
    """Each metric's run, with every wrapper's launch count set to 0 just before it and read just after."""
    from metrics_tpu_torch.classification import (
        BinaryPrecisionRecallCurve,
        MulticlassAccuracy,
        MulticlassPrecisionRecallCurve,
    )
    from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    out = {}
    rng = np.random.default_rng(seed)
    t_start = time.perf_counter()

    def run(name, make, batches, expect=None):
        """``expect``: the launches per wrapper this run must show (absent wrappers: none)."""
        t_run = time.perf_counter()
        gpu, cpu = make("cuda"), make("cpu")
        update_ms = []
        for wrapper in wrappers.values():
            wrapper.launches = 0
        for a, b in batches():
            a_gpu, b_gpu = a.cuda(), b.cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu.update(a_gpu, b_gpu)
            torch.cuda.synchronize()
            update_ms.append(1000 * (time.perf_counter() - t0))
            cpu.update(a, b)
        got, want = gpu.compute(), cpu.compute()
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        # the first update also pays one-time costs (e.g. the first use of an operator), so it is kept apart
        out[name] = {"updates": gpu.update_count, "first_update_ms": update_ms[0],
                     "later_update_ms_median": float(np.median(update_ms[1:])) if len(update_ms) > 1 else None,
                     "launches": launches}
        if expect is not None:
            out[name]["expected_launches"] = expect
        SECTION_S[name] = time.perf_counter() - t_run
        return gpu, cpu, got, want

    def acc_batches():
        for _ in range(ACC_STEPS):
            yield (torch.from_numpy(rng.random((ACC_BATCH, ACC_CLASSES), dtype=np.float32)),
                   torch.from_numpy(rng.integers(0, ACC_CLASSES, ACC_BATCH)))

    gpu, cpu, got, want = run("MulticlassAccuracy", lambda d: MulticlassAccuracy(
        num_classes=ACC_CLASSES, average="micro", device=d), acc_batches)
    _same_states("MulticlassAccuracy", gpu, cpu)
    if not (torch.isfinite(got) and float(got) == float(want)):
        fail(f"MulticlassAccuracy {float(got)} on the card, {float(want)} on the CPU")
    out["MulticlassAccuracy"]["value"] = float(got)

    def prc_batches(n, c):
        def gen():
            for _ in range(PRC_STEPS):
                shape = (n,) if c == 1 else (n, c)
                yield (torch.from_numpy(rng.random(shape, dtype=np.float32)),
                       torch.from_numpy(rng.integers(0, 2 if c == 1 else c, n)))
        return gen

    for name, make, n, c in [
        ("BinaryPrecisionRecallCurve", lambda d: BinaryPrecisionRecallCurve(thresholds=PRC_THRESHOLDS, device=d),
         BIN_N, 1),
        ("MulticlassPrecisionRecallCurve", lambda d: MulticlassPrecisionRecallCurve(
            num_classes=10, thresholds=PRC_THRESHOLDS, device=d), MC_N, 10),
    ]:
        gpu, cpu, got, want = run(name, make, prc_batches(n, c))
        _same_states(name, gpu, cpu)
        for g, w in zip(got, want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()) or not torch.allclose(g.cpu(), w, rtol=1e-6):
                fail(f"{name}: curve on the card differs from the CPU run")
        out[name]["curve_shape"] = list(got[0].shape)

    def ssim_batches():
        for _ in range(SSIM_STEPS):
            a = rng.random(SSIM_SHAPE, dtype=np.float32)
            b = (0.75 * a + 0.25 * rng.random(SSIM_SHAPE, dtype=np.float32)).astype(np.float32)
            yield torch.from_numpy(a), torch.from_numpy(b)

    gpu, cpu, got, want = run("StructuralSimilarityIndexMeasure",
                              lambda d: StructuralSimilarityIndexMeasure(data_range=1.0, device=d), ssim_batches)
    if not (bool(torch.isfinite(got)) and abs(float(got) - float(want)) <= 1e-5):
        fail(f"SSIM {float(got)} on the card, {float(want)} on the CPU")
    out["StructuralSimilarityIndexMeasure"]["value"] = float(got)
    out["StructuralSimilarityIndexMeasure"]["abs_diff_vs_cpu"] = abs(float(got) - float(want))
    SECTION_S["accuracy, PR curves, SSIM"] = time.perf_counter() - t_start
    section("curve family", curve_family, rng, run, out)
    section("stat family", stat_family, rng, run, out)
    imagenet, imagenet_gpu = section("collections and sync", collections_and_sync, seed, wrappers, out)
    dryrun_checks(seed, wrappers, out, imagenet, imagenet_gpu)
    regression_and_wrappers(seed, wrappers, out, imagenet, imagenet_gpu)
    pairwise_clustering_nominal_shape(seed, wrappers, out)
    sketches_windows_drift(seed, wrappers, out, imagenet, imagenet_gpu)
    text_and_audio(seed, wrappers, out)
    APART["observe_and_durability"] = section("observe_and_durability", observe_and_durability, seed, wrappers,
                                              imagenet)
    APART["fleet_engine"] = section("fleet_engine", fleet_engine, seed, wrappers, imagenet_gpu)
    APART["serve"] = section("serve", serve_section, seed, wrappers)
    APART["model_based"] = section("model_based", model_based_section, seed, wrappers)
    APART["model_based_text_multimodal"] = section("model_based_text_multimodal", model_based_text_multimodal_section,
                                                   seed, wrappers)
    APART["observe_costs"] = section("observe_costs", observe_costs_section, seed, wrappers)
    APART["analysis_contracts"] = section("analysis_contracts", analysis_contracts_section, seed, wrappers)
    return out


def _agree(name, got, want, exact, rtol=CURVE_RTOL, atol=CURVE_ATOL):
    """Finite values of the CPU run's shapes and dtypes; equal, or within ``rtol``/``atol``. Returns the largest
    absolute difference."""
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            fail(f"{name}: the card returned another structure than the CPU run")
        return max([_agree(name, g, w, exact, rtol, atol) for g, w in zip(got, want)] + [0.0])
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} on the card, {want.dtype} {tuple(want.shape)} on the CPU")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values on the card")
    if exact and not torch.equal(got, want):
        fail(f"{name}: the card's values differ from the CPU run's")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: the card's values differ from the CPU run's beyond rtol {rtol}, atol {atol}")
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def curve_family(rng: np.random.Generator, run, out: dict) -> None:
    """The binned curve family on the main path: multilabel mAP at the 80 COCO labels, AUROC in each mode of
    the binned-counts kernel and on the exact path, and every curve class through its task wrapper."""
    from metrics_tpu_torch import classification as tc

    def multilabel(n, labels):
        target = (rng.random((n, labels)) < ML_POSITIVE).astype(np.int64)
        # informative scores: positives lean high
        preds = ((rng.random((n, labels), dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def binary(n):
        target = rng.integers(0, 2, n)
        preds = ((rng.random(n, dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def multiclass(n, classes):
        return (torch.from_numpy(rng.random((n, classes), dtype=np.float32)),
                torch.from_numpy(rng.integers(0, classes, n)))

    def batches(make, steps):
        return lambda: (make() for _ in range(steps))

    runs = [
        ("MultilabelAveragePrecision", lambda d: tc.MultilabelAveragePrecision(
            num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, average="macro", device=d),
         batches(lambda: multilabel(ML_N, ML_LABELS), PRC_STEPS), False),
        ("BinaryAUROC", lambda d: tc.BinaryAUROC(thresholds=PRC_THRESHOLDS, device=d),
         batches(lambda: binary(BIN_N), PRC_STEPS), False),
        ("MulticlassAUROC", lambda d: tc.MulticlassAUROC(num_classes=10, thresholds=PRC_THRESHOLDS, device=d),
         batches(lambda: multiclass(MC_N, 10), PRC_STEPS), False),
        ("BinaryAUROC[exact,max_fpr=0.5]", lambda d: tc.BinaryAUROC(thresholds=None, max_fpr=0.5, device=d),
         batches(lambda: binary(EXACT_N), 1), False),
    ]
    # every curve class through its task wrapper, for each task: (class, extra arguments, exact agreement)
    wrapped = [(tc.PrecisionRecallCurve, {}, True), (tc.ROC, {}, True), (tc.AveragePrecision, {}, False),
               (tc.LogAUC, {}, False), (tc.SensitivityAtSpecificity, {"min_specificity": 0.5}, True),
               (tc.SpecificityAtSensitivity, {"min_sensitivity": 0.5}, True),
               (tc.PrecisionAtFixedRecall, {"min_recall": 0.5}, True),
               (tc.RecallAtFixedPrecision, {"min_precision": 0.5}, True)]
    tasks = {"binary": ({}, lambda: binary(WRAPPED_N)),
             "multiclass": ({"num_classes": 10}, lambda: multiclass(WRAPPED_N, 10)),
             "multilabel": ({"num_labels": ML_LABELS}, lambda: multilabel(WRAPPED_N, ML_LABELS))}
    for cls, extra, exact in wrapped:
        for task, (size, make) in tasks.items():
            def factory(d, cls=cls, task=task, size=size, extra=extra):
                return cls(task=task, thresholds=PRC_THRESHOLDS, device=d, **size, **extra)
            runs.append((f"{cls.__name__}[{task}]", factory, batches(make, 1), exact))

    for name, make, feed, exact in runs:
        gpu, cpu, got, want = run(name, make, feed)
        _same_states(name, gpu, cpu)
        out[name]["max_abs_diff_vs_cpu"] = _agree(name, got, want, exact)
        if isinstance(got, torch.Tensor) and got.numel() == 1:
            out[name]["value"] = float(got)


def stat_family(rng: np.random.Generator, run, out: dict) -> None:
    """The stat-score and confusion-matrix family on the main path. None of it launches a kernel: counters and
    confusion matrices are plain tensor ops, so each run must show no launch; the float64 AUROC goes through
    the float64 binned counts, one ``binned_counts`` launch per update."""
    from metrics_tpu_torch import classification as tc

    def imagenet_batch():
        """10,000 x 1000 float32 logits whose top-1 is the target for about 75 % of the rows."""
        target = rng.integers(0, IN_CLASSES, IN_BATCH)
        guess = np.where(rng.random(IN_BATCH) < IN_TOP1, target, rng.integers(0, IN_CLASSES, IN_BATCH))
        logits = rng.standard_normal((IN_BATCH, IN_CLASSES), dtype=np.float32)
        logits[np.arange(IN_BATCH), guess] += 6.0  # above the row's other 999 normal draws
        return torch.from_numpy(logits), torch.from_numpy(target)

    imagenet = [imagenet_batch() for _ in range(IN_STEPS)]
    top1 = float(np.mean([float((p.argmax(1) == t).float().mean()) for p, t in imagenet]))
    log(f"ImageNet-1k inputs: {IN_STEPS} x {IN_BATCH} x {IN_CLASSES}, top-1 {top1:.4f}")

    def coco_batch():
        target = (rng.random((ML_N, ML_LABELS)) < ML_POSITIVE).astype(np.int64)
        preds = ((rng.random((ML_N, ML_LABELS), dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    coco = [coco_batch() for _ in range(PRC_STEPS)]

    def grades():
        target = rng.integers(0, KAPPA_GRADES, KAPPA_N)
        preds = np.clip(target + rng.integers(-1, 2, KAPPA_N) * (rng.random(KAPPA_N) < 0.4), 0, KAPPA_GRADES - 1)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def binary64():
        target = rng.integers(0, 2, BIN_N)
        preds = (rng.random(BIN_N) + 0.5 * target) / 1.5  # float64
        return torch.from_numpy(preds), torch.from_numpy(target)

    def shared(batches):
        return lambda: iter(batches)

    def batches(make, steps):
        return lambda: (make() for _ in range(steps))

    # (name, factory, batches, exact, rtol, atol, expected launches)
    runs = [
        ("ImageNet MulticlassPrecision", lambda d: tc.MulticlassPrecision(num_classes=IN_CLASSES, device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassRecall", lambda d: tc.MulticlassRecall(num_classes=IN_CLASSES, device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassF1Score", lambda d: tc.MulticlassF1Score(num_classes=IN_CLASSES, average="macro",
                                                                      device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassConfusionMatrix", lambda d: tc.MulticlassConfusionMatrix(num_classes=IN_CLASSES,
                                                                                      device=d),
         shared(imagenet), True, 0, 0, {}),
        ("ImageNet MulticlassMatthewsCorrCoef", lambda d: tc.MulticlassMatthewsCorrCoef(num_classes=IN_CLASSES,
                                                                                        device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassJaccardIndex", lambda d: tc.MulticlassJaccardIndex(num_classes=IN_CLASSES, device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassCalibrationError", lambda d: tc.MulticlassCalibrationError(
            num_classes=IN_CLASSES, n_bins=15, norm="l1", device=d), shared(imagenet), False, SUM_RTOL, SUM_ATOL, {}),
        ("ImageNet MulticlassPrecision[top_k=5]", lambda d: tc.MulticlassPrecision(num_classes=IN_CLASSES, top_k=5,
                                                                                   device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelF1Score", lambda d: tc.MultilabelF1Score(num_labels=ML_LABELS, average="macro", device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelHammingDistance", lambda d: tc.MultilabelHammingDistance(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelExactMatch", lambda d: tc.MultilabelExactMatch(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelCoverageError", lambda d: tc.MultilabelCoverageError(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelRankingAveragePrecision", lambda d: tc.MultilabelRankingAveragePrecision(
            num_labels=ML_LABELS, device=d), shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelRankingLoss", lambda d: tc.MultilabelRankingLoss(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("MulticlassCohenKappa[quadratic]", lambda d: tc.MulticlassCohenKappa(
            num_classes=KAPPA_GRADES, weights="quadratic", device=d), batches(grades, PRC_STEPS), False,
         STAT_RTOL, STAT_ATOL, {}),
    ]
    # every new class through its task wrapper for each task it has, on 2^16 rows
    sizes = {"binary": {}, "multiclass": {"num_classes": 10}, "multilabel": {"num_labels": ML_LABELS}}

    def logits(task):
        if task == "binary":
            return lambda: (torch.from_numpy(rng.standard_normal(WRAPPED_N, dtype=np.float32)),
                            torch.from_numpy(rng.integers(0, 2, WRAPPED_N)))
        if task == "multiclass":
            return lambda: (torch.from_numpy(rng.standard_normal((WRAPPED_N, 10), dtype=np.float32)),
                            torch.from_numpy(rng.integers(0, 10, WRAPPED_N)))
        return lambda: (torch.from_numpy(rng.standard_normal((WRAPPED_N, ML_LABELS), dtype=np.float32)),
                        torch.from_numpy((rng.random((WRAPPED_N, ML_LABELS)) < ML_POSITIVE).astype(np.int64)))

    three = ("binary", "multiclass", "multilabel")
    wrapped = [(tc.Precision, {}, three), (tc.Recall, {}, three), (tc.FBetaScore, {"beta": 2.0}, three),
               (tc.F1Score, {}, three), (tc.Specificity, {}, three), (tc.NegativePredictiveValue, {}, three),
               (tc.HammingDistance, {}, three), (tc.ConfusionMatrix, {}, three), (tc.JaccardIndex, {}, three),
               (tc.MatthewsCorrCoef, {}, three), (tc.ExactMatch, {}, ("multiclass", "multilabel")),
               (tc.CohenKappa, {}, ("binary", "multiclass")), (tc.CalibrationError, {}, ("binary", "multiclass")),
               (tc.HingeLoss, {}, ("binary", "multiclass"))]
    for cls, extra, tasks in wrapped:
        for task in tasks:
            def factory(d, cls=cls, task=task, extra=extra):
                return cls(task=task, device=d, **sizes[task], **extra)
            summed = cls in (tc.CalibrationError, tc.HingeLoss)
            runs.append((f"{cls.__name__}[{task}]", factory, batches(logits(task), 1), cls is tc.ConfusionMatrix,
                         SUM_RTOL if summed else STAT_RTOL, SUM_ATOL if summed else STAT_ATOL, {}))
    runs.append(("Dice[multiclass,macro]", lambda d: tc.Dice(average="macro", num_classes=10, device=d),
                 batches(logits("multiclass"), 1), False, STAT_RTOL, STAT_ATOL, {}))

    for name, make, feed, exact, rtol, atol, expect in runs:
        gpu, cpu, got, want = run(name, make, feed, expect)
        _same_states(name, gpu, cpu, rtol, atol)
        out[name]["max_abs_diff_vs_cpu"] = _agree(name, got, want, exact, rtol, atol)
        if isinstance(got, torch.Tensor) and got.numel() == 1:
            out[name]["value"] = float(got)

    # float64 scores under torch's float64 default: the float64 binned counts, compared in float64
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        name = "BinaryAUROC[float64]"
        gpu, cpu, got, want = run(name, lambda d: tc.BinaryAUROC(thresholds=PRC_THRESHOLDS, device=d),
                                  batches(binary64, PRC_STEPS), {"binned_counts": PRC_STEPS})
        _same_states(name, gpu, cpu)
        out[name]["max_abs_diff_vs_cpu"] = _agree(name, got, want, False)
        out[name]["value"] = float(got)
    finally:
        torch.set_default_dtype(previous)


def _median_ms(times):
    return float(np.median(times[1:])) if len(times) > 1 else None


def _timed(fn):
    """``fn()`` between two synchronizations; returns (result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, 1000 * (time.perf_counter() - t0)


def _agree_dict(name, got, want, exact, rtol, atol=0.0):
    if sorted(got) != sorted(want):
        fail(f"{name}: keys {sorted(got)} on the card, {sorted(want)} on the CPU")
    return max(_agree(f"{name}[{k}]", got[k], want[k], exact and not want[k].is_floating_point(), rtol, atol)
               for k in want)


def imagenet_members(d):
    """The ImageNet-1k evaluation's collection members."""
    from metrics_tpu_torch import classification as tc

    return [tc.MulticlassAccuracy(num_classes=IN_CLASSES, average="micro", device=d),
            tc.MulticlassPrecision(num_classes=IN_CLASSES, device=d),
            tc.MulticlassRecall(num_classes=IN_CLASSES, device=d),
            tc.MulticlassF1Score(num_classes=IN_CLASSES, average="macro", device=d),
            tc.MulticlassConfusionMatrix(num_classes=IN_CLASSES, device=d)]


def coco80_batch(rng: np.random.Generator):
    """One update of the COCO-80 multilabel inputs: ``ML_N`` images x 80 labels, about 3.6 % present, scores
    leaning towards the present labels."""
    target = (rng.random((ML_N, ML_LABELS)) < ML_POSITIVE).astype(np.int64)
    preds = ((rng.random((ML_N, ML_LABELS), dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
    return torch.from_numpy(preds), torch.from_numpy(target)


def coco80_collection(d):
    """Multilabel AP and AUROC over the COCO-80 inputs in one collection, their compute group given."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch import classification as tc

    return MetricCollection([tc.MultilabelAveragePrecision(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, device=d),
                             tc.MultilabelAUROC(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, device=d)],
                            compute_groups=[["MultilabelAveragePrecision", "MultilabelAUROC"]])


def collections_and_sync(seed: int, wrappers: dict, out: dict):
    """The collection, aggregation and sync layer on the main path; each run with every wrapper's launch count
    set to 0 just before it and read just after, and its expected launches."""
    from metrics_tpu_torch import CatMetric, MeanMetric, MetricCollection, SumMetric
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.regression import (
        ConcordanceCorrCoef,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        NormalizedRootMeanSquaredError,
        PearsonCorrCoef,
        R2Score,
        SpearmanCorrCoef,
    )

    rng = np.random.default_rng(seed + 5)

    def counting(name, expect, body):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = body()
        torch.cuda.synchronize()
        out.setdefault(name, {}).update({"launches": {k: w.launches for k, w in wrappers.items()},
                                         "expected_launches": expect})
        return result

    # 1. the ImageNet-1k evaluation as one collection, beside three aggregators
    def imagenet_batch():
        target = rng.integers(0, IN_CLASSES, IN_BATCH)
        guess = np.where(rng.random(IN_BATCH) < IN_TOP1, target, rng.integers(0, IN_CLASSES, IN_BATCH))
        logits = rng.standard_normal((IN_BATCH, IN_CLASSES), dtype=np.float32)
        logits[np.arange(IN_BATCH), guess] += 6.0
        return torch.from_numpy(logits), torch.from_numpy(target)

    imagenet = [imagenet_batch() for _ in range(IN_STEPS)]
    imagenet_gpu = [(p.cuda(), t.cuda()) for p, t in imagenet]

    members = imagenet_members

    def aggregators(d):
        return {"MeanMetric[cross-entropy]": MeanMetric(device=d), "SumMetric[samples]": SumMetric(device=d),
                "CatMetric[arg-max]": CatMetric(device=d)}

    coll_gpu, coll_cpu = MetricCollection(members("cuda")), MetricCollection(members("cpu"))
    agg_gpu, agg_cpu = aggregators("cuda"), aggregators("cpu")

    def run_imagenet():
        # the card's updates back to back, then the CPU run: a CPU update of 10,000 x 1000 between two timed
        # card updates (as ``run`` does for the single metrics) slows the next update's host side
        coll_ms = [_timed(lambda: coll_gpu.update(pg, tg))[1] for pg, tg in imagenet_gpu]
        agg_ms = {k: [_timed(lambda: _feed_aggregator(k, m, pg, tg))[1] for pg, tg in imagenet_gpu]
                  for k, m in agg_gpu.items()}
        for p, t in imagenet:
            coll_cpu.update(p, t)
            for k, metric in agg_cpu.items():
                _feed_aggregator(k, metric, p, t)
        return coll_ms, agg_ms, coll_gpu.compute(), coll_cpu.compute()

    coll_ms, agg_ms, got, want = counting("ImageNet MetricCollection", {}, run_imagenet)
    groups = {0: ["MulticlassAccuracy"], 1: ["MulticlassPrecision", "MulticlassRecall", "MulticlassF1Score"],
              2: ["MulticlassConfusionMatrix"]}
    if coll_gpu.compute_groups != groups or coll_cpu.compute_groups != groups:
        fail(f"ImageNet collection: compute groups {coll_gpu.compute_groups} on the card, "
             f"{coll_cpu.compute_groups} on the CPU, expected {groups}")
    row = out["ImageNet MetricCollection"]
    row.update({"updates": coll_gpu["MulticlassAccuracy"].update_count, "first_update_ms": coll_ms[0],
                "later_update_ms_median": _median_ms(coll_ms), "compute_groups": coll_gpu.compute_groups,
                "max_abs_diff_vs_cpu": _agree_dict("ImageNet MetricCollection", got, want, True, STAT_RTOL,
                                                   STAT_ATOL)})
    alone, interleaved = {}, {}
    for metric, twin in zip(members("cuda"), members("cpu")):
        alone[type(metric).__name__] = _median_ms([_timed(lambda: metric.update(pg, tg))[1]
                                                   for pg, tg in imagenet_gpu])
        metric.reset()
        times = []
        for (p, t), (pg, tg) in zip(imagenet, imagenet_gpu):
            times.append(_timed(lambda: metric.update(pg, tg))[1])
            twin.update(p, t)
        interleaved[type(metric).__name__] = _median_ms(times)
    row["members_alone_later_update_ms_median"] = alone
    row["members_alone_sum_ms"] = float(sum(alone.values()))
    # each member alone with its CPU twin updated between two timed updates, the conditions of ``run``
    row["members_alone_interleaved_ms_median"] = interleaved
    for name in agg_gpu:
        got_a, want_a = agg_gpu[name].compute(), agg_cpu[name].compute()
        exact = name != "MeanMetric[cross-entropy]"
        out[f"ImageNet {name}"] = {
            "updates": agg_gpu[name].update_count, "first_update_ms": agg_ms[name][0],
            "later_update_ms_median": _median_ms(agg_ms[name]), "launches": row["launches"],
            "expected_launches": {},
            "max_abs_diff_vs_cpu": _agree(name, got_a, want_a, exact, SUM_RTOL, SUM_ATOL)}
    if float(agg_gpu["SumMetric[samples]"].compute()) != IN_STEPS * IN_BATCH:
        fail("SumMetric of the samples did not count the 50,000 images")
    log(f"ImageNet collection: groups {coll_gpu.compute_groups}; later update {row['later_update_ms_median']:.3f} ms"
        f" against {row['members_alone_sum_ms']:.3f} ms for its members alone ({alone})")

    # 2. multilabel AP and AUROC over the COCO-80 inputs, one compute group
    coco = [coco80_batch(rng) for _ in range(PRC_STEPS)]
    coco_gpu = [(p.cuda(), t.cuda()) for p, t in coco]
    pair = ["MultilabelAveragePrecision", "MultilabelAUROC"]
    for label, groups_arg, launches in [("given", [pair], PRC_STEPS), ("detected", True, PRC_STEPS + 1)]:
        def make(d):
            return MetricCollection([tc.MultilabelAveragePrecision(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS,
                                                                   device=d),
                                     tc.MultilabelAUROC(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, device=d)],
                                    compute_groups=groups_arg)
        gpu, cpu = make("cuda"), make("cpu")
        name = f"COCO-80 MetricCollection[AP+AUROC, groups {label}]"

        def run_coco():
            times = [_timed(lambda: gpu.update(pg, tg))[1] for pg, tg in coco_gpu]
            for p, t in coco:
                cpu.update(p, t)
            return times, gpu.compute()

        times, got = counting(name, {"binned_counts": launches}, run_coco)
        if gpu.compute_groups != {0: pair}:
            fail(f"{name}: compute groups {gpu.compute_groups}")
        out[name].update({"updates": PRC_STEPS, "first_update_ms": times[0],
                          "later_update_ms_median": _median_ms(times),
                          "max_abs_diff_vs_cpu": _agree_dict(name, got, cpu.compute(), False, CURVE_RTOL,
                                                             CURVE_ATOL)})
    coco_alone = {}
    for metric in (tc.MultilabelAveragePrecision(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, device="cuda"),
                   tc.MultilabelAUROC(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, device="cuda")):
        coco_alone[type(metric).__name__] = _median_ms([_timed(lambda: metric.update(pg, tg))[1]
                                                        for pg, tg in coco_gpu])
    out["COCO-80 MetricCollection[AP+AUROC, groups given]"]["members_alone_later_update_ms_median"] = coco_alone
    out["COCO-80 MetricCollection[AP+AUROC, groups given]"]["members_alone_sum_ms"] = float(sum(coco_alone.values()))

    # 3. regression over 2^22 samples, RMSE as a composition, the ImageNet collection through functional()
    def reg_batch():
        y = rng.standard_normal(REG_N, dtype=np.float32)
        x = (0.8 * y + 0.5 * rng.standard_normal(REG_N, dtype=np.float32)).astype(np.float32)
        return torch.from_numpy(x), torch.from_numpy(y)

    regression = [reg_batch() for _ in range(REG_STEPS)]
    regression_gpu = [(x.cuda(), y.cuda()) for x, y in regression]
    reg_makers = {"MeanSquaredError": lambda d: MeanSquaredError(device=d),
                  "MeanAbsoluteError": lambda d: MeanAbsoluteError(device=d),
                  "PearsonCorrCoef": lambda d: PearsonCorrCoef(device=d),
                  "SpearmanCorrCoef": lambda d: SpearmanCorrCoef(device=d),
                  "RMSE[MeanSquaredError() ** 0.5]": lambda d: MeanSquaredError(device=d) ** 0.5,
                  # the moment states folded by Chan's formulas and R2's sums: where a sync differs
                  "ExplainedVariance": lambda d: ExplainedVariance(device=d),
                  "NormalizedRootMeanSquaredError[std]": lambda d: NormalizedRootMeanSquaredError(
                      normalization="std", device=d),
                  "ConcordanceCorrCoef": lambda d: ConcordanceCorrCoef(device=d),
                  "R2Score": lambda d: R2Score(device=d)}
    reg_gpu = {}
    for name, make in reg_makers.items():
        gpu, cpu = make("cuda"), make("cpu")

        def run_reg():
            times = [_timed(lambda: gpu.update(x, y))[1] for x, y in regression_gpu]
            for x, y in regression:
                cpu.update(x, y)
            return times, _timed(gpu.compute)

        times, (got, compute_ms) = counting(f"regression {name}", {}, run_reg)
        rtol = CORR_RTOL if "Corr" in name else SUM_RTOL
        out[f"regression {name}"].update({
            "updates": REG_STEPS, "first_update_ms": times[0], "later_update_ms_median": _median_ms(times),
            "compute_ms": compute_ms, "value": float(got),
            "max_abs_diff_vs_cpu": _agree(name, got, cpu.compute(), False, rtol, SUM_ATOL)})
        reg_gpu[name] = gpu

    def run_functional():
        fns = coll_gpu.functional()
        state = fns.init()
        times = []
        for pg, tg in imagenet_gpu:
            state, ms = _timed(lambda: fns.update(state, pg, tg))
            times.append(ms)
        return times, sorted(state), fns.compute(state)

    times, leaders, got = counting("ImageNet MetricCollection.functional()", {}, run_functional)
    if leaders != ["MulticlassAccuracy", "MulticlassConfusionMatrix", "MulticlassPrecision"]:
        fail(f"functional() carried the states of {leaders}, not of the three group leaders")
    out["ImageNet MetricCollection.functional()"].update({
        "updates": IN_STEPS, "first_update_ms": times[0], "later_update_ms_median": _median_ms(times),
        "max_abs_diff_vs_cpu": _agree_dict("functional()", got, want, True, STAT_RTOL, STAT_ATOL)})

    # 4. group fairness over the Adult race groups
    def fair_batch():
        groups = rng.choice(len(FAIR_GROUPS), FAIR_N, p=np.array(FAIR_GROUPS) / sum(FAIR_GROUPS))
        target = (rng.random(FAIR_N) < 0.24).astype(np.int64)  # about 24 % of Adult earn more than 50K
        preds = ((rng.random(FAIR_N, dtype=np.float32) + 0.6 * target + 0.05 * groups) / 1.8).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups)

    fairness = [fair_batch() for _ in range(FAIR_STEPS)]
    fairness_gpu = [tuple(a.cuda() for a in batch) for batch in fairness]
    fair_gpu = {}
    for name, make in [("BinaryFairness[task=all]", lambda d: tc.BinaryFairness(num_groups=5, task="all", device=d)),
                       ("BinaryGroupStatRates", lambda d: tc.BinaryGroupStatRates(num_groups=5, device=d))]:
        gpu, cpu = make("cuda"), make("cpu")

        def run_fair():
            times = [_timed(lambda: gpu.update(*batch))[1] for batch in fairness_gpu]
            for batch in fairness:
                cpu.update(*batch)
            return times, gpu.compute()

        times, got = counting(f"Adult {name}", {}, run_fair)
        _same_states(name, gpu, cpu)
        out[f"Adult {name}"].update({
            "updates": FAIR_STEPS, "first_update_ms": times[0], "later_update_ms_median": _median_ms(times),
            "value": {k: v.tolist() for k, v in got.items()},
            "max_abs_diff_vs_cpu": _agree_dict(name, got, cpu.compute(), True, STAT_RTOL, STAT_ATOL)})
        fair_gpu[name] = gpu

    # 5. NCCL in a process group of one: sync -> states -> unsync, then compute() syncing inside
    synced = {**{f"ImageNet {k}": m for k, m in coll_gpu.items()}, **{f"ImageNet {k}": m for k, m in agg_gpu.items()},
              **{f"regression {k}": m for k, m in reg_gpu.items() if "RMSE" not in k},
              "Adult BinaryFairness[task=all]": fair_gpu["BinaryFairness[task=all]"]}
    res = counting("NCCL sync[world of one]", {}, lambda: nccl_world_of_one(synced))
    out["NCCL sync[world of one]"].update(res)

    # 5b. two processes on the one card in a gloo group, syncing CUDA tensors (NCCL takes one rank per device)
    res = counting("gloo sync[2 ranks, one card]", {}, lambda: gloo_two_ranks_on_one_card(seed))
    out["gloo sync[2 ranks, one card]"].update(res)

    # 6. four ranks' states folded on the card against the single stream
    res = counting("fan-in[4 ranks]", {}, lambda: fan_in_of_four(
        imagenet_gpu, regression_gpu, members, aggregators, reg_makers, coll_gpu, agg_gpu, reg_gpu))
    out["fan-in[4 ranks]"].update(res)
    return imagenet, imagenet_gpu


def _flat_state(value):
    return torch.cat([torch.atleast_1d(v) for v in value]) if isinstance(value, list) else value


def nccl_world_of_one(metrics: dict) -> dict:
    """The real NCCL collectives over CUDA tensors in a process group of one; what gloo does with CUDA tensors."""
    import tempfile

    import torch.distributed as dist

    res = {"sync_ms": {}, "compute_with_sync_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            for name, metric in metrics.items():
                local = {k: _flat_state(v) for k, v in metric.metric_state.items()}
                value = metric.compute()
                _, ms = _timed(lambda: metric.sync(distributed_available=True))
                res["sync_ms"][name] = ms
                for key, before in local.items():
                    after = metric.metric_state[key]
                    if metric._reductions[key] is None:
                        before = before.unsqueeze(0)  # None states come back one replica deep
                    if after.device.type != "cuda" or not torch.equal(after, before):
                        fail(f"NCCL sync: {name}.{key} differs from the local state after a sync of one rank")
                metric.unsync()
                for key, before in local.items():
                    if not torch.equal(_flat_state(metric.metric_state[key]), before):
                        fail(f"NCCL sync: {name}.{key} is not the local state after unsync")
                # compute() of a metric told that it is distributed syncs inside and unsyncs after
                metric._computed = None
                metric.distributed_available_fn = lambda: True
                again, ms = _timed(metric.compute)
                res["compute_with_sync_ms"][name] = ms
                metric.distributed_available_fn = None
                pairs = zip(again.values(), value.values()) if isinstance(value, dict) else [(again, value)]
                if not all(torch.equal(a, b) for a, b in pairs):
                    fail(f"NCCL sync: {name}.compute() inside a sync of one rank differs from the local value")
            res["gloo_with_cuda_tensors"] = gloo_on_cuda_tensors()
        finally:
            dist.destroy_process_group()
    res["metrics"] = len(metrics)
    log(f"NCCL sync of {len(metrics)} metrics: {json.dumps(res)}")
    return res


def gloo_on_cuda_tensors() -> dict:
    """Which collectives a gloo group takes on CUDA tensors (recorded, not required)."""
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    found = {}
    for name, call in [("all_reduce", lambda t: dist.all_reduce(t, group=group)),
                       ("broadcast", lambda t: dist.broadcast(t, src=0, group=group)),
                       ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)], t, group=group))]:
        try:
            call(torch.ones(4, device="cuda"))
            torch.cuda.synchronize()
            found[name] = "ok"
        except Exception as exc:  # noqa: BLE001 (the outcome is the finding)
            found[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    dist.destroy_process_group(group)
    return found


GLOO_RANK_ROWS = {"imagenet": [6_000, 4_000], "regression": [600_000, 448_576]}


def gloo_two_ranks_on_one_card(seed: int) -> dict:
    """Two processes on the one card in a gloo group over CUDA tensors; each rank's ``compute()`` syncs over the
    group and must equal the single stream that the rank runs itself on both ranks' inputs."""
    import tempfile

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_gloo_rank, args=(rank, 2, f"{tmp}/store", f"{tmp}/{rank}.json", seed))
                 for rank in range(2)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(300)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        results = []
        for rank, proc in enumerate(procs):
            path = os.path.join(tmp, f"{rank}.json")
            if proc.exitcode != 0 or not os.path.exists(path):
                fail(f"gloo rank {rank} on the card exited with {proc.exitcode}")
            with open(path) as fh:
                results.append(json.load(fh))
    for rank, res in enumerate(results):
        if res["errors"]:
            fail(f"gloo rank {rank} on the card: {res['errors']}")
    log(f"gloo, two ranks on one card: {json.dumps(results)}")
    return {"ranks": results}


def _gloo_rank(rank: int, world: int, store: str, out_path: str, seed: int) -> None:
    """One rank of :func:`gloo_two_ranks_on_one_card`."""
    import torch.distributed as dist

    from metrics_tpu_torch import CatMetric, MeanMetric, MetricCollection
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.regression import (
        ConcordanceCorrCoef,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        NormalizedRootMeanSquaredError,
        PearsonCorrCoef,
        R2Score,
        SpearmanCorrCoef,
    )

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    errors, compute_ms = [], {}
    try:
        def shard(r):
            rng = np.random.default_rng(seed + 100 + r)
            n, m = GLOO_RANK_ROWS["imagenet"][r], GLOO_RANK_ROWS["regression"][r]
            logits = rng.standard_normal((n, IN_CLASSES), dtype=np.float32)
            labels = rng.integers(0, IN_CLASSES, n)
            logits[np.arange(n), labels] += 3.0
            y = rng.standard_normal(m, dtype=np.float32)
            x = (0.8 * y + 0.5 * rng.standard_normal(m, dtype=np.float32)).astype(np.float32)
            return [torch.from_numpy(a).cuda() for a in (logits, labels, x, y)]

        def make(**kw):
            collection = MetricCollection([
                tc.MulticlassAccuracy(num_classes=IN_CLASSES, average="micro", device="cuda", **kw),
                tc.MulticlassPrecision(num_classes=IN_CLASSES, device="cuda", **kw),
                tc.MulticlassF1Score(num_classes=IN_CLASSES, average="macro", device="cuda", **kw),
                tc.MulticlassConfusionMatrix(num_classes=IN_CLASSES, device="cuda", **kw)])
            regression = {"MeanSquaredError": MeanSquaredError(device="cuda", **kw),
                          "MeanAbsoluteError": MeanAbsoluteError(device="cuda", **kw),
                          "PearsonCorrCoef": PearsonCorrCoef(device="cuda", **kw),
                          "SpearmanCorrCoef": SpearmanCorrCoef(device="cuda", **kw)}
            return collection, regression, MeanMetric(device="cuda", **kw), CatMetric(device="cuda", **kw)

        def feed(metrics, logits, labels, x, y):
            collection, regression, mean, cat = metrics
            collection.update(logits, labels)
            for metric in regression.values():
                metric.update(x, y)
            mean.update(x)
            cat.update(labels)

        local, whole = make(), make(sync_on_compute=False)
        feed(local, *shard(rank))
        for r in range(world):
            feed(whole, *shard(r))
        pairs = [(f"ImageNet {k}", m, whole[0][k]) for k, m in local[0].items()]
        pairs += [(k, m, whole[1][k]) for k, m in local[1].items()]
        pairs += [("MeanMetric", local[2], whole[2]), ("CatMetric", local[3], whole[3])]
        for name, metric, single in pairs:
            got, ms = _timed(metric.compute)
            compute_ms[name] = ms
            want = single.compute()
            exact = not want.is_floating_point() or name == "CatMetric"
            rtol = CORR_RTOL if "Corr" in name else FOLD_RTOL
            if got.shape != want.shape or got.dtype != want.dtype or not (
                    torch.equal(got, want) if exact else torch.allclose(got, want, rtol=rtol, atol=1e-6)):
                errors.append(f"{name}: {got.flatten()[:4].tolist()} against the single stream's "
                              f"{want.flatten()[:4].tolist()}")
            if metric._is_synced:
                errors.append(f"{name}: left synced after compute()")
    except Exception as exc:  # noqa: BLE001 (reported to the parent, which fails)
        errors.append(f"{type(exc).__name__}: {exc}")
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as fh:
            json.dump({"rank": rank, "errors": errors, "compute_with_sync_ms": compute_ms}, fh)


def fan_in_of_four(imagenet_gpu, regression_gpu, members, aggregators, reg_makers, coll_gpu, agg_gpu,
                   reg_gpu) -> dict:
    """Split the ImageNet and regression inputs over four ranks of unequal size (one rank empty for the list
    states), fold their states with ``allreduce_over_mesh`` and hold the result against the single stream."""
    from metrics_tpu_torch.parallel import allreduce_over_mesh

    def split(tensors, sizes):
        whole = [torch.cat(parts) for parts in zip(*tensors)]
        bounds = np.cumsum([0] + sizes)
        return [[t[bounds[r]:bounds[r + 1]] for t in whole] for r in range(len(sizes))]

    res = {"fold_ms": {}, "max_abs_diff_vs_single_stream": {}}

    def fold(name, makers, rank_inputs, feed, single, rtol):
        ranks = [makers() for _ in rank_inputs]
        for metric, inputs in zip(ranks, rank_inputs):
            if inputs[0].shape[0]:
                feed(metric, *inputs)
        merged, ms = _timed(lambda: allreduce_over_mesh([m.metric_state for m in ranks], ranks[0]._reductions))
        folded = makers().load_merged_state(merged, update_count=len(ranks))
        for key, value in single.metric_state.items():
            value, got = _flat_state(value), _flat_state(folded.metric_state[key])
            if not value.is_floating_point() and not torch.equal(got, value):
                fail(f"fan-in: {name}.{key} differs from the single stream")
        got, want = folded.compute(), single.compute()
        want = {k: v.cpu() for k, v in want.items()} if isinstance(want, dict) else want.cpu()
        res["fold_ms"][name] = ms
        res["max_abs_diff_vs_single_stream"][name] = (
            _agree_dict(name, got, want, False, rtol, 1e-6) if isinstance(want, dict)
            else _agree(name, got, want, rtol == 0.0, rtol, 0.0 if rtol == 0.0 else 1e-6))

    imagenet_sizes, list_sizes = [17_000, 8_000, 15_000, 10_000], [20_000, 0, 18_000, 12_000]
    stat_ranks = split(imagenet_gpu, imagenet_sizes)
    for i, single in enumerate(coll_gpu.values()):
        fold(f"ImageNet {type(single).__name__}", lambda i=i: members("cuda")[i], stat_ranks,
             lambda m, p, t: m.update(p, t), single, FOLD_RTOL)
    for name, single in agg_gpu.items():
        sizes = list_sizes if name.startswith("Cat") else imagenet_sizes
        fold(f"ImageNet {name}", lambda name=name: aggregators("cuda")[name], split(imagenet_gpu, sizes),
             lambda m, p, t, name=name: _feed_aggregator(name, m, p, t), single,
             0.0 if name.startswith(("Cat", "Sum")) else FOLD_RTOL)
    reg_sizes, reg_list_sizes = [1_500_000, 500_000, 1_200_000, (1 << 22) - 3_200_000], [1 << 21, 0, 1 << 20, 1 << 20]
    for name, single in reg_gpu.items():
        if "RMSE" in name:
            continue
        sizes = reg_list_sizes if name == "SpearmanCorrCoef" else reg_sizes
        fold(f"regression {name}", lambda name=name: reg_makers[name]("cuda"), split(regression_gpu, sizes),
             lambda m, x, y: m.update(x, y), single, CORR_RTOL if "Corr" in name else FOLD_RTOL)
    log(f"fan-in of four ranks: {json.dumps(res)}")
    return res


def _feed_aggregator(name, metric, p, t):
    """The aggregators beside the ImageNet collection: the batch's cross-entropy weighted by its size, the
    sample count, the arg-max predictions."""
    import torch.nn.functional as F

    if name.startswith("Mean"):
        metric.update(F.cross_entropy(p, t), weight=p.shape[0])
    elif name.startswith("Sum"):
        metric.update(float(p.shape[0]))
    else:
        metric.update(p.argmax(1))


# ----------------------------------------------------------------------------- phase 4, the dryrun's checks
def dryrun_checks(seed: int, wrappers: dict, out: dict, imagenet, imagenet_gpu) -> None:
    """The four checks that end the JAX package's multi-chip dryrun, on the card at real sizes: retrieval at
    MS MARCO dev scale, MAP at COCO val2017 scale, BootStrapper over the ImageNet-1k evaluation, each against
    the port's CPU run of the same inputs, with the fan-in of four ranks of each against the single stream;
    and a subgroup sync of four processes. None of these paths launches a kernel."""

    def counting(name, body):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = section(name, body)
        torch.cuda.synchronize()
        result.update({"launches": {k: w.launches for k, w in wrappers.items()}, "expected_launches": {}})
        out[name] = result

    rows = msmarco_rows(np.random.default_rng(seed + 6))
    counting("MS MARCO retrieval collection", lambda: retrieval_msmarco(rows))
    counting("retrieval fan-in[4 ranks]", lambda: retrieval_fan_in(rows, out["MS MARCO retrieval collection"]))
    del rows
    images = coco_images(np.random.default_rng(seed + 7))
    counting("COCO val2017 MeanAveragePrecision", lambda: detection_coco(images))
    counting("detection fan-in[4 ranks]", lambda: detection_fan_in(images, out["COCO val2017 MeanAveragePrecision"]))
    del images
    counting("ImageNet BootStrapper", lambda: bootstrap_imagenet(seed, imagenet, imagenet_gpu))
    counting("BootStrapper fan-in[4 ranks]", lambda: bootstrap_fan_in(seed, imagenet_gpu))
    counting("subgroup sync[4 ranks, 2 x 2]", lambda: subgroup_sync_on_card(seed))
    image_and_segmentation(seed, wrappers, out)


def msmarco_rows(rng: np.random.Generator) -> list:
    """MS MARCO passage ranking, the small dev set: 6,980 queries x 1,000 BM25-style candidates, in updates of
    698 queries. Each query has 1 + Binomial(2, 0.035) judged passages (1.07 on average); for 86 % of the
    queries (BM25's recall at 1,000 on that set) they are among the candidates, for the other 14 % none is.
    Scores are Gumbel (BM25-like, float32); a relevant passage's is raised by a Normal(4, 2) boost, which
    puts MRR@10 near BM25's 0.19 on that set."""
    qrels = 1 + rng.binomial(2, 0.035, RET_QUERIES)
    found = qrels * (rng.random(RET_QUERIES) < RET_RECALL)  # relevant passages among each query's candidates
    target = np.zeros((RET_QUERIES, RET_CANDIDATES), dtype=np.int64)
    slots = rng.random((RET_QUERIES, RET_CANDIDATES)).argsort(axis=1)[:, :3]
    for k in range(3):
        target[np.arange(RET_QUERIES), slots[:, k]] = (found > k).astype(np.int64)
    boost = rng.normal(4.0, 2.0, (RET_QUERIES, RET_CANDIDATES))
    scores = (rng.gumbel(size=(RET_QUERIES, RET_CANDIDATES)) + boost * target + 20.0).astype(np.float32)
    ids = np.repeat(np.arange(RET_QUERIES, dtype=np.int64), RET_CANDIDATES).reshape(RET_QUERIES, RET_CANDIDATES)
    per = RET_QUERIES // RET_STEPS
    return [tuple(torch.from_numpy(np.ascontiguousarray(a[i * per:(i + 1) * per].reshape(-1)))
                  for a in (ids, scores, target)) for i in range(RET_STEPS)]


def _retrieval_collection(device):
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.retrieval import RetrievalMAP, RetrievalMRR, RetrievalNormalizedDCG, RetrievalRecall

    return MetricCollection({"MRR@10": RetrievalMRR(top_k=10, device=device),
                             "NDCG@10": RetrievalNormalizedDCG(top_k=10, device=device),
                             "MAP": RetrievalMAP(device=device),
                             "Recall@100": RetrievalRecall(top_k=100, device=device)})


def _event_ms(fn, reps=3):
    """Median device time of ``fn`` over ``reps`` runs, with CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def retrieval_msmarco(rows) -> dict:
    """The four metrics in one collection (one compute group, one sorted view) on the card and on the CPU."""
    from metrics_tpu_torch.retrieval.base import GroupedQueries, _order_by_query_desc

    gpu, cpu = _retrieval_collection("cuda"), _retrieval_collection("cpu")
    rows_gpu = [tuple(t.cuda() for t in r) for r in rows]
    update_ms = [_timed(lambda: gpu.update(p, t, indexes=i))[1] for i, p, t in rows_gpu]
    for i, p, t in rows:
        cpu.update(p, t, indexes=i)
    if list(gpu.compute_groups) != [0]:
        fail(f"MS MARCO collection: compute groups {gpu.compute_groups}, expected one group")
    got, compute_ms = _timed(gpu.compute)
    want = cpu.compute()
    member = gpu["MAP"]
    indexes, preds, target = (torch.cat(getattr(member, k)) for k in ("indexes", "preds", "target"))
    sort_ms = _event_ms(lambda: _order_by_query_desc(indexes, preds))
    # the rest of compute() apart: the whole view (sort, gathers, counts), then each metric's scoring on it
    view_ms = _event_ms(lambda: GroupedQueries(indexes, preds, target))
    gq = GroupedQueries(indexes, preds, target)
    gq.ideal_graded  # built here, so that NDCG's scoring below is timed without its second sort
    score_ms = {k: _event_ms(lambda m=m: m._score_groups(gq)) for k, m in gpu.items()}
    ideal_ms = _event_ms(lambda: GroupedQueries(indexes, preds, target).ideal_graded) - view_ms
    diff = _agree_dict("MS MARCO retrieval", got, want, False, RET_RTOL, 1e-7)
    values = {k: float(v) for k, v in got.items()}
    if not 0.0 < values["MRR@10"] < 1.0:
        fail(f"MS MARCO MRR@10 {values['MRR@10']} is not a score")
    res = {"queries": RET_QUERIES, "rows": RET_QUERIES * RET_CANDIDATES, "updates": RET_STEPS, "values": values,
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "compute_ms": compute_ms, "grouping_sort_ms": sort_ms, "view_ms": view_ms, "ideal_sort_ms": ideal_ms,
           "score_ms": score_ms, "max_abs_diff_vs_cpu": diff,
           "compute_groups": gpu.compute_groups}
    log(f"MS MARCO retrieval: {json.dumps(res)}")
    res["_single_stream"] = {"MAP": got["MAP"].cpu(), "NDCG@10": got["NDCG@10"].cpu()}
    return res


def retrieval_fan_in(rows, single: dict) -> dict:
    """The dryrun's two retrieval checks: ``compute_flat`` over the concatenation of four ranks' shards, and
    four ranks' NDCG list states (one rank empty) folded by ``allreduce_over_mesh``; each against the single
    stream."""
    from metrics_tpu_torch.parallel import allreduce_over_mesh
    from metrics_tpu_torch.retrieval import RetrievalMAP, RetrievalNormalizedDCG

    want = single.pop("_single_stream")
    ids, preds, target = (torch.cat(parts).cuda() for parts in zip(*rows))
    bounds = np.cumsum([0, 2_000_000, 1_500_000, 2_100_000, ids.numel() - 5_600_000])
    shards = [tuple(t[bounds[r]:bounds[r + 1]] for t in (ids, preds, target)) for r in range(4)]
    flat, flat_ms = _timed(lambda: RetrievalMAP(device="cuda").compute_flat(
        *(torch.cat(parts) for parts in zip(*[(p, t, i) for i, p, t in shards]))))
    _agree("retrieval compute_flat over four shards", flat, want["MAP"], False, RET_RTOL, 0.0)
    per_rank_queries = [2400, 0, 2600, RET_QUERIES - 5000]
    ranks, start = [], 0
    for n_queries in per_rank_queries:
        metric = RetrievalNormalizedDCG(top_k=10, device="cuda")
        rows_r = slice(start * RET_CANDIDATES, (start + n_queries) * RET_CANDIDATES)
        if n_queries:
            metric.update(preds[rows_r], target[rows_r], indexes=ids[rows_r])
        ranks.append(metric)
        start += n_queries
    merged, fold_ms = _timed(lambda: allreduce_over_mesh([m.metric_state for m in ranks],
                                                         {k: "cat" for k in ("indexes", "preds", "target")}))
    folded = RetrievalNormalizedDCG(top_k=10, device="cuda").load_merged_state(merged)
    _agree("retrieval NDCG folded from four ranks", folded.compute(), want["NDCG@10"], False, RET_RTOL, 0.0)
    res = {"compute_flat_ms": flat_ms, "compute_flat_map": float(flat), "fold_ms": fold_ms,
           "rank_queries": per_rank_queries, "folded_ndcg": float(folded.compute())}
    log(f"retrieval fan-in of four ranks: {json.dumps(res)}")
    return res


def coco_images(rng: np.random.Generator) -> list:
    """COCO val2017 at its scale: 5,000 images of 640 x 480 over 80 classes, ground truths per image from a
    negative binomial of mean 7.4 (about 36,800 boxes), 1 % crowd, areas small/medium/large in COCO's shares
    (41/34/24 %), class frequencies Zipf-like. 100 detections per image (COCO's maxDets): a jittered copy of
    each of 80 % of the ground truths, with a higher score, and false positives, 75 % of them labelled with one
    of the image's own ground-truth classes. Boxes and scores are float32 values."""
    class_p = 1.0 / np.arange(1, COCO_CLASSES + 1) ** 0.9
    class_p /= class_p.sum()
    n_gt = np.minimum(rng.negative_binomial(1.2, 1.2 / (1.2 + COCO_GT_MEAN), COCO_IMAGES), 90)

    def boxes(n, kind_p):
        kind = rng.choice(3, n, p=kind_p)
        lo, hi = np.array([16.0, 32.0**2, 96.0**2])[kind], np.array([32.0**2, 96.0**2, 200_000.0])[kind]
        area = np.exp(rng.uniform(np.log(lo), np.log(hi)))
        ratio = np.exp(rng.uniform(np.log(1 / 3), np.log(3), n))
        w, h = np.minimum(np.sqrt(area * ratio), 639.0), np.minimum(np.sqrt(area / ratio), 479.0)
        x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
        return np.stack([x, y, x + w, y + h], axis=1).astype(np.float32)

    images = []
    for ng in n_gt:
        gb = boxes(ng, [0.41 / 0.99, 0.34 / 0.99, 0.24 / 0.99])
        glab = rng.choice(COCO_CLASSES, ng, p=class_p)
        hit = rng.random(ng) < 0.8
        size = np.stack([gb[:, 2] - gb[:, 0], gb[:, 3] - gb[:, 1]] * 2, axis=1)
        tp_boxes = (gb[hit] + rng.normal(0, 0.08, (hit.sum(), 4)) * size[hit]).astype(np.float32)
        n_fp = COCO_DETS - len(tp_boxes)
        fp_boxes = boxes(n_fp, [0.5, 0.3, 0.2])
        own = rng.random(n_fp) < 0.75
        fp_lab = np.where(own & (ng > 0), glab[rng.integers(0, max(ng, 1), n_fp)] if ng else 0,
                          rng.choice(COCO_CLASSES, n_fp, p=class_p))
        db = np.concatenate([tp_boxes, fp_boxes])
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        scores = np.concatenate([rng.beta(4, 2, len(tp_boxes)), rng.beta(1, 4, n_fp)]).astype(np.float32)
        images.append(({"boxes": torch.from_numpy(db), "scores": torch.from_numpy(scores),
                        "labels": torch.from_numpy(np.concatenate([glab[hit], fp_lab]).astype(np.int64))},
                       {"boxes": torch.from_numpy(gb), "labels": torch.from_numpy(glab.astype(np.int64)),
                        "iscrowd": torch.from_numpy((rng.random(ng) < 0.01).astype(np.int64))}))
    return images


COCO_KEYS = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_1", "mar_10", "mar_100")


def detection_coco(images) -> dict:
    """MAP over the 5,000 images in 10 updates of 500, on the card and on the CPU, the matching's device time
    from the compute's own CUDA events; the IoU and GIoU metrics on the same boxes, their CPU check over the first
    ``IOU_CPU_IMAGES``."""
    from metrics_tpu_torch.detection import (
        GeneralizedIntersectionOverUnion,
        IntersectionOverUnion,
        MeanAveragePrecision,
    )

    per = COCO_IMAGES // COCO_STEPS
    gpu, cpu = MeanAveragePrecision(device="cuda"), MeanAveragePrecision(device="cpu")
    images_gpu = [({k: v.cuda() for k, v in p.items()}, {k: v.cuda() for k, v in t.items()}) for p, t in images]
    update_ms = []
    for i in range(COCO_STEPS):
        part = images_gpu[i * per:(i + 1) * per]
        update_ms.append(_timed(lambda: gpu.update([p for p, _ in part], [t for _, t in part]))[1])
        cpu.update([p for p, _ in images[i * per:(i + 1) * per]], [t for _, t in images[i * per:(i + 1) * per]])
    got, compute_ms = _timed(gpu.compute)
    stages = dict(gpu.last_evaluation["bbox"])
    want = cpu.compute()
    diff = _agree_dict("COCO MAP", {k: got[k] for k in COCO_KEYS}, {k: want[k] for k in COCO_KEYS}, False,
                       MAP_RTOL, 0.0)
    values = {k: float(got[k]) for k in COCO_KEYS}
    if not all(0.0 < values[k] < 1.0 for k in COCO_KEYS):
        fail(f"COCO MAP: values out of (0, 1): {values}")
    ious = {}
    for cls in (IntersectionOverUnion, GeneralizedIntersectionOverUnion):
        m_gpu, m_check, m_cpu = cls(device="cuda"), cls(device="cuda"), cls(device="cpu")
        _, ms = _timed(lambda: m_gpu.update([p for p, _ in images_gpu], [t for _, t in images_gpu]))
        m_check.update([p for p, _ in images_gpu[:IOU_CPU_IMAGES]], [t for _, t in images_gpu[:IOU_CPU_IMAGES]])
        m_cpu.update([p for p, _ in images[:IOU_CPU_IMAGES]], [t for _, t in images[:IOU_CPU_IMAGES]])
        iou_diff = _agree_dict(cls.__name__, m_check.compute(), m_cpu.compute(), False, IOU_RTOL, 1e-6)
        ious[cls.__name__] = {"update_ms": ms, "value": {k: float(v) for k, v in m_gpu.compute().items()},
                              "cpu_images": IOU_CPU_IMAGES, "max_abs_diff_vs_cpu": iou_diff}
    res = {"images": COCO_IMAGES, "gt_boxes": int(sum(len(t["labels"]) for _, t in images)),
           "detections": int(sum(len(p["labels"]) for p, _ in images)), "updates": COCO_STEPS, "values": values,
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "compute_ms": compute_ms, "compute_stages_s": stages, "matching_device_ms": 1000 * stages["match_device_s"],
           "max_abs_diff_vs_cpu": diff, "iou_metrics": ious}
    log(f"COCO val2017 MAP: {json.dumps(res)}")
    res["_single_stream"] = {k: got[k].cpu() for k in COCO_KEYS}
    return res


def _flat_detection_state(m) -> dict:
    """Per-image host lists as (concatenation, per-image count) tensors on the card, as the dryrun flattens
    them for the padded cat collective."""
    def cat(xs, width, dtype):
        parts = [torch.from_numpy(np.asarray(x, dtype).reshape((-1, width) if width else (-1,))) for x in xs]
        flat = torch.cat(parts) if parts else torch.zeros((0, width) if width else (0,), dtype=torch.float32)
        return flat.cuda()

    return {"det_box": cat(m.detection_box, 4, np.float32), "det_score": cat(m.detection_score, 0, np.float32),
            "det_label": cat(m.detection_label, 0, np.int32),
            "det_count": torch.tensor([len(x) for x in m.detection_label], dtype=torch.int32, device="cuda"),
            "gt_box": cat(m.gt_box, 4, np.float32), "gt_label": cat(m.gt_label, 0, np.int32),
            "gt_crowd": cat(m.gt_crowd, 0, np.int32),
            "gt_count": torch.tensor([len(x) for x in m.gt_label], dtype=torch.int32, device="cuda")}


def detection_fan_in(images, single: dict) -> dict:
    """The dryrun's ragged detection check: four ranks of uneven image counts (one empty), flattened, folded
    by ``allreduce_over_mesh`` on the card and split back into per-image states, against the single stream."""
    from metrics_tpu_torch.detection import MeanAveragePrecision
    from metrics_tpu_torch.parallel import allreduce_over_mesh

    want = single.pop("_single_stream")
    sizes = [1800, 0, 2000, COCO_IMAGES - 3800]
    bounds = np.cumsum([0] + sizes)
    flats = []
    for r in range(4):
        metric = MeanAveragePrecision(device="cuda")
        part = images[bounds[r]:bounds[r + 1]]
        if part:
            metric.update([p for p, _ in part], [t for _, t in part])
        flats.append(_flat_detection_state(metric))
    merged, fold_ms = _timed(lambda: allreduce_over_mesh(flats, {k: "cat" for k in flats[0]}))
    arrays = {k: v.cpu().numpy() for k, v in merged.items()}
    folded = MeanAveragePrecision(device="cuda")
    d_off = g_off = 0
    for nd, ng in zip(arrays["det_count"].astype(int), arrays["gt_count"].astype(int)):
        folded.detection_box.append(arrays["det_box"][d_off:d_off + nd].astype(np.float64))
        folded.detection_score.append(arrays["det_score"][d_off:d_off + nd].astype(np.float64))
        folded.detection_label.append(arrays["det_label"][d_off:d_off + nd])
        folded.detection_rle.append([])
        folded.gt_box.append(arrays["gt_box"][g_off:g_off + ng].astype(np.float64))
        folded.gt_label.append(arrays["gt_label"][g_off:g_off + ng])
        folded.gt_crowd.append(arrays["gt_crowd"][g_off:g_off + ng].astype(bool))
        folded.gt_rle.append([])
        folded.gt_area.append(None)
        d_off, g_off = d_off + nd, g_off + ng
    folded._update_count = 1
    got, compute_ms = _timed(folded.compute)
    diff = _agree_dict("detection folded from four ranks", {k: got[k] for k in COCO_KEYS}, want, False,
                       MAP_RTOL, 0.0)
    res = {"rank_images": sizes, "fold_ms": fold_ms, "compute_ms": compute_ms,
           "max_abs_diff_vs_single_stream": diff}
    log(f"detection fan-in of four ranks: {json.dumps(res)}")
    return res


def bootstrap_imagenet(seed: int, imagenet, imagenet_gpu) -> dict:
    """BootStrapper(MulticlassAccuracy, 20 copies) over the ImageNet-1k evaluation, on the card and on the
    CPU from one seed: the same rows for every copy, so equal counters."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.wrappers import BootStrapper

    def make(device):
        np.random.seed(seed)
        return BootStrapper(MulticlassAccuracy(num_classes=IN_CLASSES, average="micro", device=device),
                            num_bootstraps=BOOT_COPIES, quantile=[0.025, 0.975], raw=True)

    gpu = make("cuda")
    update_ms = [_timed(lambda: gpu.update(p, t))[1] for p, t in imagenet_gpu]
    got, compute_ms = _timed(gpu.compute)
    cpu = make("cpu")
    for p, t in imagenet:
        cpu.update(p, t)
    want = cpu.compute()
    for a, b in zip(gpu.metrics, cpu.metrics):
        _same_states("BootStrapper copy", a, b)
    diff = {k: _agree(f"ImageNet BootStrapper[{k}]", got[k], want[k], False,
                      BOOT_STD_RTOL if k == "std" else BOOT_RTOL, 0.0) for k in want}
    res = {"copies": BOOT_COPIES, "updates": len(imagenet_gpu), "first_update_ms": update_ms[0],
           "later_update_ms_median": _median_ms(update_ms), "compute_ms": compute_ms,
           "mean": float(got["mean"]), "std": float(got["std"]), "max_abs_diff_vs_cpu": diff}
    log(f"ImageNet BootStrapper: {json.dumps(res)}")
    return res


def bootstrap_fan_in(seed: int, imagenet_gpu) -> dict:
    """The dryrun's BootStrapper check: each copy's states from four uneven ranks, folded by
    ``allreduce_over_mesh``, against the copies merged rank after rank with ``merge_state``."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.parallel import allreduce_over_mesh
    from metrics_tpu_torch.wrappers import BootStrapper

    preds, target = (torch.cat(parts) for parts in zip(*imagenet_gpu))
    bounds = np.cumsum([0, 17_000, 8_000, 15_000, 10_000])
    base = MulticlassAccuracy(num_classes=IN_CLASSES, average="micro", device="cuda")
    np.random.seed(seed + 1)
    ranks = []
    for r in range(4):
        wrapper = BootStrapper(base, num_bootstraps=BOOT_COPIES)
        wrapper.update(preds[bounds[r]:bounds[r + 1]], target[bounds[r]:bounds[r + 1]])
        ranks.append(wrapper)
    fold_ms, worst = [], 0.0
    for j in range(BOOT_COPIES):
        merged, ms = _timed(lambda: allreduce_over_mesh([w.metrics[j].metric_state for w in ranks],
                                                        ranks[0].metrics[j]._reductions))
        fold_ms.append(ms)
        via_fan_in = base.clone()
        via_fan_in.load_merged_state(merged)
        offline = ranks[0].metrics[j].clone()
        for w in ranks[1:]:
            offline.merge_state(w.metrics[j])
        worst = max(worst, _agree(f"BootStrapper copy {j} folded", via_fan_in.compute(), offline.compute().cpu(),
                                  False, BOOT_RTOL, 0.0))
    res = {"copies": BOOT_COPIES, "rank_rows": [int(b) for b in np.diff(bounds)],
           "fold_ms_median": float(np.median(fold_ms)), "max_abs_diff_vs_merge_state": worst}
    log(f"BootStrapper fan-in of four ranks: {json.dumps(res)}")
    return res


def subgroup_sync_on_card(seed: int) -> dict:
    """Four processes on the one card in a gloo world laid out as (model 2, data 2), one ``dist.new_group``
    per data row: each rank's accuracy syncs over its row only and must equal the single stream over its
    row's shards."""
    import tempfile

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_subgroup_rank, args=(rank, 4, f"{tmp}/store", f"{tmp}/{rank}.json", seed))
                 for rank in range(4)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(300)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        results = []
        for rank, proc in enumerate(procs):
            path = os.path.join(tmp, f"{rank}.json")
            if proc.exitcode != 0 or not os.path.exists(path):
                fail(f"subgroup rank {rank} on the card exited with {proc.exitcode}")
            with open(path) as fh:
                results.append(json.load(fh))
    for res in results:
        if res["errors"]:
            fail(f"subgroup rank {res['rank']} on the card: {res['errors']}")
    log(f"subgroup sync, four ranks on one card: {json.dumps(results)}")
    return {"ranks": results}


def _subgroup_rank(rank: int, world: int, store: str, out_path: str, seed: int) -> None:
    """One rank of :func:`subgroup_sync_on_card`."""
    import torch.distributed as dist

    from metrics_tpu_torch.classification import MulticlassAccuracy

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    errors, res = [], {}
    try:
        model, data = 2, world // 2
        rows = [dist.new_group(list(range(m * data, (m + 1) * data)), backend="gloo") for m in range(model)]
        row, d = divmod(rank, data)

        def shard(dd):  # the data axis splits the batch; the model axis replicates it
            rng = np.random.default_rng(seed + 200 + dd)
            return (torch.from_numpy(rng.integers(0, 5, SUBGROUP_ROWS)).cuda(),
                    torch.from_numpy(rng.integers(0, 5, SUBGROUP_ROWS)).cuda())

        local = MulticlassAccuracy(num_classes=5, average="micro", process_group=rows[row], device="cuda")
        whole = MulticlassAccuracy(num_classes=5, average="micro", sync_on_compute=False, device="cuda")
        local.update(*shard(d))
        for dd in range(data):
            whole.update(*shard(dd))
        got, ms = _timed(local.compute)
        want = whole.compute()
        if got.device.type != "cuda" or not torch.equal(got, want):
            errors.append(f"row {row}: {float(got)} against the single stream's {float(want)}")
        res = {"row": row, "value": float(got), "compute_with_sync_ms": ms}
        for group in rows:
            dist.destroy_process_group(group)
    except Exception as exc:  # noqa: BLE001 (reported to the parent, which fails)
        errors.append(f"{type(exc).__name__}: {exc}")
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as fh:
            json.dump({"rank": rank, "errors": errors, **res}, fh)


# ----------------------------------------------------------------------------- phase 4, image and segmentation
def image_and_segmentation(seed: int, wrappers: dict, out: dict) -> None:
    """Super-resolution evaluation at DIV2K validation scale (PSNR, SSIM and MS-SSIM through the window
    kernel), 3-D SSIM at BraTS volume size (no kernel), mask MAP at COCO val2017 image sizes (the RLE codec,
    the mask IoUs on the card) and panoptic quality at COCO panoptic scale (the pixel pass on the card); each
    against the port's CPU run of a stated subset of the same inputs."""

    def counting(name, expect, body):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = section(name, body)
        torch.cuda.synchronize()
        result.update({"launches": {k: w.launches for k, w in wrappers.items()}, "expected_launches": expect})
        out[name] = result

    counting("DIV2K super-resolution collection", {"ssim_window": DIV2K_IMAGES * (1 + MS_SSIM_SCALES)},
             lambda: div2k_collection(seed, wrappers["ssim_window"]))
    counting("BraTS 3-D SSIM", {}, lambda: brats_ssim(seed))
    images = coco_images(np.random.default_rng(seed + 7))[:SEGM_IMAGES]
    counting("COCO val2017 segm MeanAveragePrecision", {}, lambda: segm_coco(seed, images))
    del images
    counting("COCO panoptic quality", {}, lambda: panoptic_coco(seed))
    image_rest_and_segmentation(seed, counting)


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def div2k_pair(g: torch.Generator):
    """One (super-resolved, high-resolution) pair of 3 x 1356 x 2040 float32 images in [0, 1] on the card: a
    smooth image (bilinear upsampling of 85 x 128 noise, plus fine grain) and the same image with the error of
    a reconstruction."""
    h, w = DIV2K_SHAPE
    coarse = torch.rand((1, 3, h // 16, w // 16), generator=g, device="cuda")
    target = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    target = (target + 0.03 * torch.randn(target.shape, generator=g, device="cuda")).clamp(0, 1)
    preds = (target + 0.04 * torch.randn(target.shape, generator=g, device="cuda")).clamp(0, 1)
    return preds, target


def div2k_collection(seed: int, ssim_window) -> dict:
    """PSNR, SSIM and MS-SSIM (``data_range=1.0``) in one collection over 100 DIV2K-sized pairs, one image an
    update; each member's window-kernel launches read around its own updates. The CPU run covers the first
    ``DIV2K_CPU_IMAGES`` pairs and is held against the card's compute after as many updates."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.image import (
        MultiScaleStructuralSimilarityIndexMeasure,
        PeakSignalNoiseRatio,
        StructuralSimilarityIndexMeasure,
    )

    def make(device):
        return MetricCollection({"psnr": PeakSignalNoiseRatio(data_range=1.0, device=device),
                                 "ssim": StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
                                 "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device)})

    gpu, cpu = make("cuda"), make("cpu")
    per_metric = {name: 0 for name in gpu.keys()}
    for name, member in gpu.items():
        def counted(*args, _inner=member.update, _name=name, **kwargs):
            before = ssim_window.launches
            _inner(*args, **kwargs)
            per_metric[_name] += ssim_window.launches - before
        member.update = counted
    g = _generator(seed + 8)
    update_ms, diff = [], None
    for i in range(DIV2K_IMAGES):
        preds, target = div2k_pair(g)
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        if i < DIV2K_CPU_IMAGES:
            cpu.update(preds.cpu(), target.cpu())
        if i == DIV2K_CPU_IMAGES - 1:
            got, want = gpu.compute(), cpu.compute()
            diff = {"psnr": _agree("DIV2K PSNR", got["psnr"], want["psnr"], False, PSNR_RTOL, 0.0),
                    "ssim": _agree("DIV2K SSIM", got["ssim"], want["ssim"], False, 0.0, SSIM_VALUE_ATOL),
                    "ms_ssim": _agree("DIV2K MS-SSIM", got["ms_ssim"], want["ms_ssim"], False, 0.0, SSIM_VALUE_ATOL)}
    got, compute_ms = _timed(gpu.compute)
    values = {k: float(v) for k, v in got.items()}
    if not (20.0 < values["psnr"] < 60.0 and 0.0 < values["ssim"] < 1.0 and 0.0 < values["ms_ssim"] < 1.0):
        fail(f"DIV2K: values out of range: {values}")
    expect = {"psnr": 0, "ssim": DIV2K_IMAGES, "ms_ssim": DIV2K_IMAGES * MS_SSIM_SCALES}
    if per_metric != expect:
        fail(f"DIV2K: window-kernel launches per metric {per_metric}, expected {expect}")
    res = {"images": DIV2K_IMAGES, "shape": [3, *DIV2K_SHAPE], "cpu_images": DIV2K_CPU_IMAGES, "values": values,
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "compute_ms": compute_ms, "launches_per_metric": per_metric, "max_abs_diff_vs_cpu": diff}
    log(f"DIV2K super-resolution: {json.dumps(res)}")
    return res


def brats_ssim(seed: int) -> dict:
    """3-D SSIM (11 x 11 x 11 gaussian window) over BraTS-sized volumes, 4 MRI modalities x 155 x 240 x 240,
    one volume an update, on the shifted-slice cascade (no kernel). The check: the first ``BRATS_CPU_DEPTH``
    slices of the first volume at full height and width, through the port on the card and on the CPU."""
    from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    g = _generator(seed + 9)
    gpu = StructuralSimilarityIndexMeasure(data_range=1.0, device="cuda")
    update_ms, diff = [], None
    for i in range(BRATS_VOLUMES):
        coarse = torch.rand((1, 4, 20, 30, 30), generator=g, device="cuda")
        target = F.interpolate(coarse, size=BRATS_SHAPE, mode="trilinear", align_corners=False)
        preds = (target + 0.05 * torch.randn(target.shape, generator=g, device="cuda")).clamp(0, 1)
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        if i == 0:
            slab = preds[:, :, :BRATS_CPU_DEPTH], target[:, :, :BRATS_CPU_DEPTH]
            card = StructuralSimilarityIndexMeasure(data_range=1.0, device="cuda")
            card.update(*slab)
            cpu = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
            t0 = time.perf_counter()
            cpu.update(*(x.cpu() for x in slab))
            cpu_ms = 1000 * (time.perf_counter() - t0)
            diff = _agree("BraTS 3-D SSIM", card.compute(), cpu.compute(), False, 0.0, SSIM_VALUE_ATOL)
    got, compute_ms = _timed(gpu.compute)
    if not 0.0 < float(got) < 1.0:
        fail(f"BraTS 3-D SSIM {float(got)} is not a similarity")
    res = {"volumes": BRATS_VOLUMES, "shape": [4, *BRATS_SHAPE], "cpu_shape": [4, BRATS_CPU_DEPTH, *BRATS_SHAPE[1:]],
           "value": float(got),
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "cpu_update_ms": cpu_ms, "compute_ms": compute_ms, "max_abs_diff_vs_cpu": diff}
    log(f"BraTS 3-D SSIM: {json.dumps(res)}")
    return res


def _coco_sizes(rng: np.random.Generator, n: int) -> list:
    """(h, w) of each image, a synthetic mix: 640 on the long side, as COCO's images are scaled, landscape for
    70 % of them, the short side 480 for half of them and drawn uniformly from 240 to 640 for the rest, so that
    most sizes are held by one image or a few. The shares are this script's choice: COCO val2017's own table of
    sizes is not in this repository."""
    short = np.where(rng.random(n) < 0.5, 480, rng.integers(240, 641, n))
    landscape = rng.random(n) < 0.7
    return [(int(s), 640) if wide else (640, int(s)) for s, wide in zip(short, landscape)]


def _fit_boxes(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The box MAP path's boxes, laid out on a 640 x 480 image, moved onto an (h, w) image: turned for a
    portrait image, then scaled."""
    if h > w:
        boxes = boxes[:, [1, 0, 3, 2]]
        sx, sy = w / 480, h / 640
    else:
        sx, sy = w / 640, h / 480
    return boxes * torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype, device=boxes.device)


def ellipse_masks(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(n, h, w) bool masks on the boxes' device: the filled ellipse inscribed in each xyxy box."""
    x0, y0, x1, y1 = boxes.float().unbind(1)
    cx, cy = ((x0 + x1) / 2)[:, None, None], ((y0 + y1) / 2)[:, None, None]
    rx, ry = ((x1 - x0) / 2).clamp(min=0.5)[:, None, None], ((y1 - y0) / 2).clamp(min=0.5)[:, None, None]
    ys = torch.arange(h, device=boxes.device, dtype=torch.float32)[None, :, None] + 0.5
    xs = torch.arange(w, device=boxes.device, dtype=torch.float32)[None, None, :] + 0.5
    return ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1


def segm_coco(seed: int, images: list) -> dict:
    """``MeanAveragePrecision(iou_type=("bbox", "segm"))`` over the first ``SEGM_IMAGES`` of the box path's COCO
    val2017 images at the sizes of ``_coco_sizes``, each box with its inscribed ellipse as mask, made on the
    card; updates of ``SEGM_PER_UPDATE`` images. The CPU run covers the first update's images, held against the card's
    compute after that update; the card's RLE states equal the CPU's there."""
    from metrics_tpu_torch.detection import MeanAveragePrecision

    sizes = _coco_sizes(np.random.default_rng(seed + 10), len(images))
    gpu = MeanAveragePrecision(iou_type=("bbox", "segm"), device="cuda")
    cpu = MeanAveragePrecision(iou_type=("bbox", "segm"), device="cpu")
    update_ms, diff, n_masks, check_s = [], None, 0, 0.0
    for start in range(0, len(images), SEGM_PER_UPDATE):
        preds, target = [], []
        for (p, t), (h, w) in zip(images[start:start + SEGM_PER_UPDATE], sizes[start:start + SEGM_PER_UPDATE]):
            pb, tb = _fit_boxes(p["boxes"].cuda(), h, w), _fit_boxes(t["boxes"].cuda(), h, w)
            preds.append({"boxes": pb, "masks": ellipse_masks(pb, h, w), "scores": p["scores"].cuda(),
                          "labels": p["labels"].cuda()})
            target.append({"boxes": tb, "masks": ellipse_masks(tb, h, w), "labels": t["labels"].cuda(),
                           "iscrowd": t["iscrowd"].cuda()})
            n_masks += len(pb) + len(tb)
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        if start == 0:
            t0 = time.perf_counter()
            cpu.update([{k: v.cpu() for k, v in d.items()} for d in preds],
                       [{k: v.cpu() for k, v in d.items()} for d in target])
            if gpu.detection_rle != cpu.detection_rle or gpu.gt_rle != cpu.gt_rle:
                fail("COCO segm: the card's RLE states differ from the CPU run's")
            got, want = gpu.compute(), cpu.compute()
            keys = [f"{kind}_{k}" for kind in ("bbox", "segm") for k in COCO_KEYS]
            diff = _agree_dict("COCO segm MAP", {k: got[k] for k in keys}, {k: want[k] for k in keys}, False,
                               MAP_RTOL, 0.0)
            check_s = time.perf_counter() - t0
        del preds, target
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, compute_ms = _timed(gpu.compute)
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    stages = {kind: dict(gpu.last_evaluation[kind]) for kind in ("bbox", "segm")}
    values = {f"{kind}_{k}": float(got[f"{kind}_{k}"]) for kind in ("bbox", "segm") for k in COCO_KEYS}
    if not all(0.0 < v < 1.0 for v in values.values()):
        fail(f"COCO segm MAP: values out of (0, 1): {values}")
    segm = stages["segm"]
    res = {"images": len(images), "cpu_images": SEGM_PER_UPDATE, "distinct_sizes": len(set(sizes)),
           "images_of_480_short_side": sum(min(s) == 480 for s in sizes), "masks": n_masks,
           "updates": len(update_ms), "values": values, "first_update_ms": update_ms[0],
           "later_update_ms_median": _median_ms(update_ms), "update_ms_per_image":
           float(np.median(update_ms[1:] if len(update_ms) > 1 else update_ms)) / SEGM_PER_UPDATE,
           "compute_s": compute_ms / 1000, "compute_stages_s": stages,
           "f64_iou_unit_share": segm["f64_iou_units"] / max(1, segm["f64_iou_units"] + segm["f32_iou_units"]),
           "compute_peak_device_mb": peak_mb, "cpu_check_s": check_s, "max_abs_diff_vs_cpu": diff}
    log(f"COCO val2017 segm MAP: {json.dumps(res)}")
    return res


def panoptic_maps(g: torch.Generator, b: int):
    """(b, 480, 640, 2) int64 (category, instance) maps on the card, target and prediction: 4 stuff regions
    (a Voronoi partition, categories 80-132) under 7 thing instances (ellipses, categories 0-79), about 11
    segments an image. The prediction moves every region and instance a little, gives 10 % of the instances
    another category, drops 10 % and adds one false instance."""
    h, w = PQ_SHAPE
    ys = torch.arange(h, device="cuda", dtype=torch.float32)[None, None, :, None] + 0.5
    xs = torch.arange(w, device="cuda", dtype=torch.float32)[None, None, None, :] + 0.5
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")  # noqa: E731
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    seeds = rand(b, 4, 2) * torch.tensor([w, h], device="cuda")
    stuff = PQ_THINGS + (rand(b, 4) * PQ_STUFFS).long()
    centers = rand(b, 8, 2) * torch.tensor([w, h], device="cuda")
    radii = 20 + rand(b, 8, 2) * 100
    things = (rand(b, 8) * PQ_THINGS).long()
    keep = torch.ones((b, 8), dtype=torch.bool, device="cuda")

    def paint(seeds, stuff, centers, radii, things, keep):
        d = (xs - seeds[..., 0, None, None]) ** 2 + (ys - seeds[..., 1, None, None]) ** 2  # (b, 4, h, w)
        cat = torch.gather(stuff, 1, d.argmin(1).reshape(b, -1)).reshape(b, h, w)
        inst = torch.zeros_like(cat)
        for k in range(centers.shape[1]):
            inside = (((xs[:, 0] - centers[:, k, 0, None, None]) / radii[:, k, 0, None, None]) ** 2
                      + ((ys[:, 0] - centers[:, k, 1, None, None]) / radii[:, k, 1, None, None]) ** 2 <= 1)
            inside &= keep[:, k, None, None]
            cat = torch.where(inside, things[:, k, None, None], cat)
            inst = torch.where(inside, torch.full_like(inst, k + 1), inst)
        return torch.stack([cat, inst], dim=-1)

    target_keep = keep.clone()
    target_keep[:, 7] = False  # the eighth instance is the prediction's false one
    target = paint(seeds, stuff, centers, radii, things, target_keep)
    pred_things = torch.where(rand(b, 8) < 0.1, (rand(b, 8) * PQ_THINGS).long(), things)
    pred_keep = keep & (rand(b, 8) >= 0.1)
    preds = paint(seeds + 15 * randn(b, 4, 2), stuff, centers + 6 * randn(b, 8, 2), radii * (1 + 0.1 * randn(b, 8, 2)),
                  pred_things, pred_keep)
    return preds, target


def panoptic_coco(seed: int) -> dict:
    """``PanopticQuality`` and ``ModifiedPanopticQuality`` (133 categories: 80 things, 53 stuffs; SQ, RQ and
    per-class values) over ``PQ_IMAGES`` images of 480 x 640 in updates of ``PQ_PER_UPDATE``. The CPU run covers
    the first ``PQ_CPU_IMAGES`` images, its states held against the card's after as many."""
    from metrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality

    things, stuffs = set(range(PQ_THINGS)), set(range(PQ_THINGS, PQ_THINGS + PQ_STUFFS))
    kw = {"return_sq_and_rq": True, "return_per_class": True}
    gpu = {"pq": PanopticQuality(things, stuffs, device="cuda", **kw),
           "modified_pq": ModifiedPanopticQuality(things, stuffs, device="cuda", **kw)}
    cpu = {"pq": PanopticQuality(things, stuffs, device="cpu", **kw),
           "modified_pq": ModifiedPanopticQuality(things, stuffs, device="cpu", **kw)}
    g = _generator(seed + 11)
    update_ms = {k: [] for k in gpu}
    diff = None
    for start in range(0, PQ_IMAGES, PQ_PER_UPDATE):
        preds, target = panoptic_maps(g, PQ_PER_UPDATE)
        for k, m in gpu.items():
            update_ms[k].append(_timed(lambda: m.update(preds, target))[1])
        if start < PQ_CPU_IMAGES:
            p_cpu, t_cpu = preds.cpu(), target.cpu()
            for m in cpu.values():
                m.update(p_cpu, t_cpu)
        if start + PQ_PER_UPDATE == PQ_CPU_IMAGES:
            for k in gpu:
                _same_states(f"COCO panoptic {k}", gpu[k], cpu[k], rtol=PQ_RTOL)
            diff = {k: _agree(f"COCO panoptic {k}", gpu[k].compute(), cpu[k].compute(), False, PQ_RTOL, 0.0)
                    for k in gpu}
    values = {}
    for k, m in gpu.items():
        got = m.compute()
        if got.shape != (1, 3, PQ_THINGS + PQ_STUFFS) or not bool(((got >= 0) & (got <= 1)).all()):
            fail(f"COCO panoptic {k}: per-class values {tuple(got.shape)} out of [0, 1]")
        valid = (m.true_positives + m.false_positives + m.false_negatives) > 0
        values[k] = {name: float(got[0, i][valid].mean()) for i, name in enumerate(("pq", "sq", "rq"))}
    res = {"images": PQ_IMAGES, "cpu_images": PQ_CPU_IMAGES, "shape": [*PQ_SHAPE, 2],
           "categories": {"things": PQ_THINGS, "stuffs": PQ_STUFFS},
           "segments_per_image": float((gpu["pq"].true_positives.sum() + gpu["pq"].false_negatives.sum()) / PQ_IMAGES),
           "values": values, "update_ms": {k: {"first": v[0], "later_median": _median_ms(v)}
                                           for k, v in update_ms.items()},
           "update_ms_per_image": {k: _median_ms(v) / PQ_PER_UPDATE for k, v in update_ms.items()},
           "max_abs_diff_vs_cpu": diff}
    log(f"COCO panoptic quality: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------------------- phase 4, the rest of image, segmentation
def image_rest_and_segmentation(seed: int, counting) -> None:
    """Pansharpening at WorldView-3 size (UQI, SAM, ERGAS, RASE, RMSE-SW and SCC at reduced resolution; D_lambda,
    D_s and QNR at full resolution), VIF at LIVE size, PSNR-B on JPEG-like blocking, total variation and image
    gradients on the DIV2K-sized images, mean IoU, Dice and generalized Dice at Cityscapes val scale, and the
    Hausdorff distance on Cityscapes maps and BraTS volumes; each against the port's CPU run of a stated subset.
    The window metrics launch the window kernel at ``compute()`` (their states keep every input): the launches of
    each metric are read around its own compute."""
    counting("WorldView-3 reduced-resolution collection", {"ssim_window": 2 * 5},
             lambda: wv3_reduced_resolution(seed))
    counting("WorldView-3 full-resolution D_lambda, D_s, QNR", {"ssim_window": 2 * (2 + 3 + 5)},
             lambda: wv3_full_resolution(seed))
    counting("LIVE VIF", {"ssim_window": 2 * (1 + 2 * (VIF_SCALES - 1))}, lambda: live_vif(seed))
    counting("JPEG deblocking PSNR-B", {}, lambda: jpeg_psnrb(seed))
    counting("DIV2K total variation and image gradients", {}, lambda: div2k_total_variation(seed))
    counting("Cityscapes segmentation collection", {}, lambda: cityscapes_segmentation(seed))
    counting("Cityscapes and BraTS Hausdorff", {}, lambda: hausdorff_cityscapes_brats(seed))


def _count_launches(members: dict, method: str) -> dict:
    """Wrap each member's ``method`` so that the window-kernel launches inside it are added to its entry."""
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    per = {name: 0 for name in members}
    for name, member in members.items():
        def counted(*args, _inner=getattr(member, method), _name=name, **kwargs):
            before = ssim_window.launches
            result = _inner(*args, **kwargs)
            per[_name] += ssim_window.launches - before
            return result
        setattr(member, method, counted)
    return per


def _peak_mb(base: int) -> float:
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _reset_peak() -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _agree_values(name: str, got: dict, want: dict, tolerances: dict) -> dict:
    """Each key within its (rtol, atol); returns the largest absolute difference of each."""
    return {k: _agree(f"{name}[{k}]", got[k], want[k], False, *tolerances[k]) for k in want}


def wv3_scene(g: torch.Generator, b: int, size: int) -> torch.Tensor:
    """(b, 8, size, size) reflectance-like float32 in [0, 1] on the card: a smooth scene shared by the bands
    (a multispectral scene's bands are strongly correlated), each band with its own gain and detail."""
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")  # noqa: E731
    up = lambda x: F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)  # noqa: E731
    base = up(rand(b, 1, size // 16, size // 16))
    detail = up(rand(b, WV3_BANDS, size // 4, size // 4))
    gains = 0.6 + 0.4 * rand(b, WV3_BANDS, 1, 1)
    grain = torch.randn((b, WV3_BANDS, size, size), generator=g, device="cuda")
    return (gains * base + 0.2 * detail + 0.02 * grain).clamp(0, 1)


def _fused(g: torch.Generator, scene: torch.Tensor) -> torch.Tensor:
    """A pansharpened estimate of ``scene``: its detail smoothed a little, with noise."""
    smooth = F.avg_pool2d(scene, 3, stride=1, padding=1, count_include_pad=False)
    noise = torch.randn(scene.shape, generator=g, device="cuda")
    return (0.7 * scene + 0.3 * smooth + 0.01 * noise).clamp(0, 1)


def wv3_reduced_resolution(seed: int) -> dict:
    """UQI, SAM, ERGAS (ratio 4), RASE, RMSE-SW and SCC in one collection over 20 fused images of 8 x 256 x 256
    against their references (Wald's protocol: the reference is the original MS image), updates of 4; each
    member's window launches read around its compute. The six keep the same two list states, so the collection
    makes them one compute group. CPU check: the first 2 images through a card and a CPU collection."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.image import (
        ErrorRelativeGlobalDimensionlessSynthesis,
        RelativeAverageSpectralError,
        RootMeanSquaredErrorUsingSlidingWindow,
        SpatialCorrelationCoefficient,
        SpectralAngleMapper,
        UniversalImageQualityIndex,
    )

    def make(device):
        return MetricCollection({
            "uqi": UniversalImageQualityIndex(device=device), "sam": SpectralAngleMapper(device=device),
            "ergas": ErrorRelativeGlobalDimensionlessSynthesis(ratio=WV3_RATIO, device=device),
            "rase": RelativeAverageSpectralError(device=device),
            "rmse_sw": RootMeanSquaredErrorUsingSlidingWindow(device=device),
            "scc": SpatialCorrelationCoefficient(device=device)})

    tolerances = {"uqi": (0.0, WINDOW_VALUE_ATOL), "sam": (IMAGE_RTOL, 1e-7), "ergas": (IMAGE_RTOL, 1e-7),
                  "rase": (IMAGE_RTOL, 1e-7), "rmse_sw": (0.0, WINDOW_VALUE_ATOL), "scc": (0.0, WINDOW_VALUE_ATOL)}
    g = _generator(seed + 13)
    gpu, card_check, cpu = make("cuda"), make("cuda"), make("cpu")
    per_metric = _count_launches(dict(gpu.items()), "compute")
    update_ms, diff = [], None
    base = _reset_peak()
    for start in range(0, WV3_IMAGES, WV3_UPDATE):
        target = wv3_scene(g, WV3_UPDATE, WV3_REDUCED)
        preds = _fused(g, target)
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        if start == 0:
            slab = preds[:WV3_CPU_IMAGES], target[:WV3_CPU_IMAGES]
            card_check.update(*slab)
            cpu.update(*(x.cpu() for x in slab))
            diff = _agree_values("WV3 reduced resolution", card_check.compute(), cpu.compute(), tolerances)
    got, compute_ms = _timed(gpu.compute)
    values = {k: float(v) for k, v in got.items()}
    if not (0.0 < values["uqi"] <= 1.0 and 0.0 < values["scc"] <= 1.0 and
            all(values[k] > 0 for k in ("sam", "ergas", "rase", "rmse_sw"))):
        fail(f"WV3 reduced resolution: values out of range: {values}")
    expect = {"uqi": 1, "sam": 0, "ergas": 0, "rase": 2, "rmse_sw": 1, "scc": 1}
    if per_metric != expect:
        fail(f"WV3 reduced resolution: window-kernel launches per metric {per_metric}, expected {expect}")
    res = {"images": WV3_IMAGES, "shape": [WV3_BANDS, WV3_REDUCED, WV3_REDUCED], "cpu_images": WV3_CPU_IMAGES,
           "compute_groups": len(gpu.compute_groups), "values": values, "first_update_ms": update_ms[0],
           "later_update_ms_median": _median_ms(update_ms), "compute_ms": compute_ms,
           "peak_device_mb": _peak_mb(base), "launches_per_metric": per_metric, "max_abs_diff_vs_cpu": diff}
    log(f"WorldView-3 reduced resolution: {json.dumps(res)}")
    return res


def wv3_full_resolution(seed: int) -> dict:
    """D_lambda (fused against MS), D_s and QNR over 20 fused images of 8 x 512 x 512, MS 8 x 128 x 128 (the
    scene's 4 x 4 means) and PAN 512 x 512 (the bands' mean) repeated over the 8 bands, dict targets without
    ``pan_lr`` (so the uniform filter and the antialiased resize run), updates of 4. CPU check: the first 2
    images through card and CPU metrics."""
    from metrics_tpu_torch.image import QualityWithNoReference, SpatialDistortionIndex, SpectralDistortionIndex

    def make(device):
        return {"d_lambda": SpectralDistortionIndex(device=device), "d_s": SpatialDistortionIndex(device=device),
                "qnr": QualityWithNoReference(device=device)}

    def feed(metrics, fused, ms, pan):
        for name, m in metrics.items():
            if name == "d_lambda":
                m.update(fused, ms)
            else:
                m.update(fused, {"ms": ms, "pan": pan})

    g = _generator(seed + 14)
    gpu, card_check, cpu = make("cuda"), make("cuda"), make("cpu")
    per_metric = _count_launches(gpu, "compute")
    update_ms, diff = [], None
    base = _reset_peak()
    for start in range(0, WV3_IMAGES, WV3_UPDATE):
        scene = wv3_scene(g, WV3_UPDATE, WV3_FULL)
        ms = F.avg_pool2d(scene, WV3_RATIO)
        pan = scene.mean(1, keepdim=True).expand(-1, WV3_BANDS, -1, -1).contiguous()
        fused = _fused(g, scene)
        update_ms.append(_timed(lambda: feed(gpu, fused, ms, pan))[1])
        if start == 0:
            n = WV3_CPU_IMAGES
            feed(card_check, fused[:n], ms[:n], pan[:n])
            feed(cpu, fused[:n].cpu(), ms[:n].cpu(), pan[:n].cpu())
            diff = _agree_values("WV3 full resolution", {k: m.compute() for k, m in card_check.items()},
                                 {k: m.compute() for k, m in cpu.items()}, {k: (IMAGE_RTOL, 1e-6) for k in cpu})
    compute_ms, values = {}, {}
    for name, m in gpu.items():
        got, compute_ms[name] = _timed(m.compute)
        values[name] = float(got)
    if not (0.0 <= values["d_lambda"] < 1.0 and 0.0 <= values["d_s"] < 1.0 and 0.0 < values["qnr"] <= 1.0):
        fail(f"WV3 full resolution: values out of range: {values}")
    expect = {"d_lambda": 2, "d_s": 3, "qnr": 5}
    if per_metric != expect:
        fail(f"WV3 full resolution: window-kernel launches per metric {per_metric}, expected {expect}")
    res = {"images": WV3_IMAGES, "shape": [WV3_BANDS, WV3_FULL, WV3_FULL],
           "ms_shape": [WV3_BANDS, WV3_FULL // WV3_RATIO, WV3_FULL // WV3_RATIO], "cpu_images": WV3_CPU_IMAGES,
           "values": values, "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "compute_ms": compute_ms, "peak_device_mb": _peak_mb(base), "launches_per_metric": per_metric,
           "max_abs_diff_vs_cpu": diff}
    log(f"WorldView-3 full resolution: {json.dumps(res)}")
    return res


def live_pair(g: torch.Generator, b: int, distort: str):
    """(b, 3, 512, 768) float32 pairs in [0, 255] on the card: a smooth reference with grain, and the reference
    blurred (a 5 x 5 box) or with white noise (sigma 10)."""
    h, w = LIVE_SHAPE
    coarse = torch.rand((b, 3, h // 16, w // 16), generator=g, device="cuda")
    target = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False) * 255
    target = (target + 4 * torch.randn(target.shape, generator=g, device="cuda")).clamp(0, 255)
    if distort == "blur":
        preds = F.avg_pool2d(target, 5, stride=1, padding=2, count_include_pad=False)
    else:
        preds = (target + 10 * torch.randn(target.shape, generator=g, device="cuda")).clamp(0, 255)
    return preds, target


def live_vif(seed: int) -> dict:
    """VIF over 200 pairs of 3 x 512 x 768 in updates of 20, blurred and noisy updates in turn: seven window
    launches at compute (scale 0, then the low-pass and the statistics at each of scales 1-3). CPU check: the
    first 4 pairs through card and CPU metrics."""
    from metrics_tpu_torch.image import VisualInformationFidelity

    g = _generator(seed + 15)
    gpu = VisualInformationFidelity(device="cuda")
    per_metric = _count_launches({"vif": gpu}, "compute")
    update_ms, diff = [], None
    base = _reset_peak()
    for i, start in enumerate(range(0, LIVE_PAIRS, LIVE_UPDATE)):
        preds, target = live_pair(g, LIVE_UPDATE, "blur" if i % 2 == 0 else "noise")
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        if start == 0:
            slab = preds[:LIVE_CPU_PAIRS], target[:LIVE_CPU_PAIRS]
            card = VisualInformationFidelity(device="cuda")
            card.update(*slab)
            cpu = VisualInformationFidelity(device="cpu")
            cpu.update(*(x.cpu() for x in slab))
            diff = _agree("LIVE VIF", card.compute(), cpu.compute(), False, VIF_RTOL, 0.0)
    got, compute_ms = _timed(gpu.compute)
    if not 0.0 < float(got) < 1.0:
        fail(f"LIVE VIF {float(got)} is out of (0, 1) for distorted pairs")
    expect = {"vif": 1 + 2 * (VIF_SCALES - 1)}
    if per_metric != expect:
        fail(f"LIVE VIF: window-kernel launches {per_metric}, expected {expect}")
    res = {"pairs": LIVE_PAIRS, "shape": [3, *LIVE_SHAPE], "cpu_pairs": LIVE_CPU_PAIRS, "value": float(got),
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "compute_ms": compute_ms, "peak_device_mb": _peak_mb(base), "launches_per_metric": per_metric,
           "max_abs_diff_vs_cpu": diff}
    log(f"LIVE VIF: {json.dumps(res)}")
    return res


def jpeg_pair(g: torch.Generator, b: int):
    """(b, 1, 512, 512) float32 in [0, 255] on the card: a smooth image, and the same image with each 8 x 8
    block's mean quantized to steps of ``JPEG_STEP`` (the DC term of a JPEG block)."""
    coarse = torch.rand((b, 1, JPEG_SIZE // 16, JPEG_SIZE // 16), generator=g, device="cuda")
    target = F.interpolate(coarse, size=(JPEG_SIZE, JPEG_SIZE), mode="bilinear", align_corners=False) * 255
    target = (target + 3 * torch.randn(target.shape, generator=g, device="cuda")).clamp(0, 255)
    means = F.avg_pool2d(target, 8)
    shift = F.interpolate(torch.round(means / JPEG_STEP) * JPEG_STEP - means, scale_factor=8, mode="nearest")
    return (target + shift).clamp(0, 255), target


def jpeg_psnrb(seed: int) -> dict:
    """PSNR-B over 100 grayscale 512 x 512 images with 8 x 8 blocking, updates of 10. CPU check: the first 10
    through card and CPU metrics."""
    from metrics_tpu_torch.image import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect

    g = _generator(seed + 16)
    gpu = PeakSignalNoiseRatioWithBlockedEffect(device="cuda")
    psnr = PeakSignalNoiseRatio(data_range=255.0, device="cuda")
    update_ms, diff = [], None
    base = _reset_peak()
    for start in range(0, JPEG_IMAGES, JPEG_UPDATE):
        preds, target = jpeg_pair(g, JPEG_UPDATE)
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        psnr.update(preds, target)
        if start == 0:
            card = PeakSignalNoiseRatioWithBlockedEffect(device="cuda")
            card.update(preds[:JPEG_CPU_IMAGES], target[:JPEG_CPU_IMAGES])
            cpu = PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
            cpu.update(preds[:JPEG_CPU_IMAGES].cpu(), target[:JPEG_CPU_IMAGES].cpu())
            diff = _agree("JPEG PSNR-B", card.compute(), cpu.compute(), False, IMAGE_RTOL, 0.0)
    got, compute_ms = _timed(gpu.compute)
    plain_psnr = float(psnr.compute())
    if not 0.0 < float(got) < plain_psnr:
        fail(f"JPEG PSNR-B {float(got)} is not below the PSNR {plain_psnr} of blocky images")
    res = {"images": JPEG_IMAGES, "shape": [1, JPEG_SIZE, JPEG_SIZE], "cpu_images": JPEG_CPU_IMAGES,
           "value": float(got), "psnr": plain_psnr, "first_update_ms": update_ms[0],
           "later_update_ms_median": _median_ms(update_ms), "compute_ms": compute_ms,
           "peak_device_mb": _peak_mb(base), "max_abs_diff_vs_cpu": diff}
    log(f"JPEG PSNR-B: {json.dumps(res)}")
    return res


def div2k_total_variation(seed: int) -> dict:
    """Total variation with reduction "sum", "mean" and None, and image gradients, over the 100 DIV2K-sized
    images (the high-resolution images of the PSNR/SSIM path's generator), updates of 4. CPU check: the first 2
    images through card and CPU metrics, and their gradients."""
    from metrics_tpu_torch.functional.image import image_gradients
    from metrics_tpu_torch.image import TotalVariation

    def make(device):
        return {str(r): TotalVariation(reduction=r, device=device) for r in ("sum", "mean", None)}

    g = _generator(seed + 8)
    gpu = make("cuda")
    update_ms, gradient_ms, diff = [], [], None
    base = _reset_peak()
    for start in range(0, DIV2K_IMAGES, TV_UPDATE):
        img = torch.cat([div2k_pair(g)[1] for _ in range(TV_UPDATE)])
        update_ms.append(_timed(lambda: [m.update(img) for m in gpu.values()])[1])
        (dy, dx), ms = _timed(lambda: image_gradients(img))
        gradient_ms.append(ms)
        if start == 0:
            slab = img[:DIV2K_CPU_IMAGES]
            card, cpu = make("cuda"), make("cpu")
            for m in card.values():
                m.update(slab)
            for m in cpu.values():
                m.update(slab.cpu())
            diff = {k: _agree(f"DIV2K TV[{k}]", card[k].compute(), cpu[k].compute(), False, IMAGE_RTOL, 0.0)
                    for k in cpu}
            for name, got, want in zip(("dy", "dx"), (dy[:DIV2K_CPU_IMAGES], dx[:DIV2K_CPU_IMAGES]),
                                       image_gradients(slab.cpu())):
                diff[name] = _agree(f"DIV2K image gradients[{name}]", got, want, True)
    values, compute_ms = _timed(lambda: {k: m.compute() for k, m in gpu.items()})
    if values["None"].shape != (DIV2K_IMAGES,) or not torch.allclose(values["None"].sum(), values["sum"], rtol=1e-4):
        fail("DIV2K TV: the per-image scores do not add up to the sum")
    res = {"images": DIV2K_IMAGES, "shape": [3, *DIV2K_SHAPE], "cpu_images": DIV2K_CPU_IMAGES,
           "values": {"sum": float(values["sum"]), "mean": float(values["mean"])},
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "gradients_ms_median": _median_ms(gradient_ms), "compute_ms": compute_ms, "peak_device_mb": _peak_mb(base),
           "max_abs_diff_vs_cpu": diff}
    log(f"DIV2K total variation: {json.dumps(res)}")
    return res


def cityscapes_maps(g: torch.Generator, b: int):
    """(b, 1024, 2048) int64 (prediction, target) label maps on the card: 19 classes on a 16 x 32 grid of 64 x 64
    cells (coarse regions, as road, buildings and sky make a street scene), void 255 on the bottom 64 rows (the
    ego vehicle); the prediction moves the region borders by a smooth displacement of a few pixels and gives 5 %
    of the cells another class."""
    h, w = CITY_SHAPE
    gh, gw = h // 64, w // 64
    cells = (torch.rand((b, gh, gw), generator=g, device="cuda") * CITY_CLASSES).long()
    ys = torch.arange(h, device="cuda", dtype=torch.float32)[None, :, None] + 0.5
    xs = torch.arange(w, device="cuda", dtype=torch.float32)[None, None, :] + 0.5

    def paint(cells, dy, dx):
        yy = ((ys + dy) / 64).floor().clamp(0, gh - 1).long()
        xx = ((xs + dx) / 64).floor().clamp(0, gw - 1).long()
        return torch.gather(cells.reshape(b, -1), 1, (yy * gw + xx).expand(b, h, w).reshape(b, -1)).reshape(b, h, w)

    target = paint(cells, 0.0, 0.0)
    target[:, -64:] = 255
    disp = F.interpolate(6 * torch.randn((b, 2, h // 128, w // 128), generator=g, device="cuda"), size=(h, w),
                         mode="bilinear", align_corners=False)
    other = (cells + 1 + (torch.rand(cells.shape, generator=g, device="cuda") * (CITY_CLASSES - 1)).long())
    wrong = torch.rand(cells.shape, generator=g, device="cuda") < 0.05
    preds = paint(torch.where(wrong, other % CITY_CLASSES, cells), disp[:, 0], disp[:, 1])
    return preds, target


def cityscapes_segmentation(seed: int) -> dict:
    """``MeanIoU(per_class=True)``, ``DiceScore(average="macro")`` and ``GeneralizedDiceScore`` in one collection
    over 100 label maps of 1024 x 2048 (19 classes, index input), updates of 4: counted on the card, no one-hot
    masks. CPU check: the first update's states and scores, counts equal, scores within ``SEG_RTOL``."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.segmentation import DiceScore, GeneralizedDiceScore, MeanIoU

    def make(device):
        kw = {"num_classes": CITY_CLASSES, "input_format": "index", "device": device}
        return MetricCollection({"miou": MeanIoU(per_class=True, **kw), "dice": DiceScore(average="macro", **kw),
                                 "gdice": GeneralizedDiceScore(**kw)})

    g = _generator(seed + 17)
    gpu, cpu = make("cuda"), make("cpu")
    update_ms, diff = [], None
    base = _reset_peak()
    for start in range(0, CITY_MAPS, CITY_UPDATE):
        preds, target = cityscapes_maps(g, CITY_UPDATE)
        update_ms.append(_timed(lambda: gpu.update(preds, target))[1])
        if start == 0:
            cpu.update(preds.cpu(), target.cpu())
            _same_states("Cityscapes dice", gpu["dice"], cpu["dice"])  # per-map, per-class counts: equal
            for name in ("miou", "gdice"):  # sums of float scores
                _same_states(f"Cityscapes {name}", gpu[name], cpu[name], rtol=SEG_RTOL)
            got, want = gpu.compute(), cpu.compute()
            diff = {k: _agree(f"Cityscapes {k}", got[k], want[k], False, SEG_RTOL, 0.0) for k in want}
    got, compute_ms = _timed(gpu.compute)
    if got["miou"].shape != (CITY_CLASSES,) or not all(0.0 < float(got[k].mean()) < 1.0 for k in got):
        fail(f"Cityscapes: scores out of (0, 1): { {k: float(v.mean()) for k, v in got.items()} }")
    res = {"maps": CITY_MAPS, "shape": list(CITY_SHAPE), "classes": CITY_CLASSES, "cpu_maps": CITY_UPDATE,
           "values": {"miou": float(got["miou"].mean()), "dice": float(got["dice"]), "gdice": float(got["gdice"])},
           "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
           "update_ms_per_map": _median_ms(update_ms) / CITY_UPDATE, "compute_ms": compute_ms,
           "peak_device_mb": _peak_mb(base), "max_abs_diff_vs_cpu": diff}
    log(f"Cityscapes segmentation: {json.dumps(res)}")
    return res


def brats_labels(g: torch.Generator):
    """(1, 155, 240, 240) int64 BraTS-like labels and a prediction on the card: a tumour at a random centre,
    necrotic core (1) inside enhancing tumour (3) inside edema (2), each a blob whose radius varies smoothly
    with direction; the prediction moves the centre by up to 3 voxels and scales the blob by up to 10 %.
    Returns the centre too."""
    d, h, w = BRATS_SHAPE
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")  # noqa: E731
    centre = torch.tensor([d / 2, h / 2, w / 2], device="cuda") + (rand(3) - 0.5) * torch.tensor([40., 60., 60.],
                                                                                                 device="cuda")
    axes = torch.tensor([30.0, 45.0, 40.0], device="cuda")
    bumps = F.interpolate(rand(1, 1, 5, 6, 6) - 0.5, size=BRATS_SHAPE, mode="trilinear", align_corners=False)[0, 0]
    grid = torch.meshgrid(*(torch.arange(n, device="cuda", dtype=torch.float32) for n in BRATS_SHAPE),
                          indexing="ij")

    def paint(centre, scale):
        r = sum(((x - c) / (a * scale)) ** 2 for x, c, a in zip(grid, centre, axes)).sqrt() * (1 + 0.3 * bumps)
        labels = torch.zeros(BRATS_SHAPE, dtype=torch.int64, device="cuda")
        labels[r < 1.0] = 2
        labels[r < 0.55] = 3
        labels[r < 0.35] = 1
        return labels[None]

    target = paint(centre, 1.0)
    preds = paint(centre + (rand(3) - 0.5) * 6, 1.0 + (float(rand(1)) - 0.5) * 0.2)
    return preds, target, [int(c) for c in centre]


def hausdorff_cityscapes_brats(seed: int) -> dict:
    """``HausdorffDistance`` (index input, background left out) over 10 Cityscapes maps (19 classes) and 3
    BraTS-sized volumes (4 labels), one map or volume an update: edges and their distances on the card in
    float64. CPU check: a stated crop of the first map and of the first volume through the function on the card
    and on the CPU, equal."""
    from metrics_tpu_torch.functional.segmentation import hausdorff_distance
    from metrics_tpu_torch.segmentation import HausdorffDistance

    def check(name, preds, target, num_classes):
        got = hausdorff_distance(preds, target, num_classes, input_format="index").cpu()
        t0 = time.perf_counter()
        want = hausdorff_distance(preds.cpu(), target.cpu(), num_classes, input_format="index")
        cpu_s = time.perf_counter() - t0
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name}: the card's Hausdorff distances on the crop differ from the CPU run's")
        return {"crop_values": got.tolist(), "cpu_s": cpu_s}

    res = {}
    g = _generator(seed + 18)
    city = HausdorffDistance(num_classes=CITY_CLASSES, input_format="index", device="cuda")
    update_ms = []
    base = _reset_peak()
    for i in range(CITY_HD_MAPS):
        preds, target = cityscapes_maps(g, 1)
        update_ms.append(_timed(lambda: city.update(preds, target))[1])
        if i == 0:
            h, w = CITY_CROP
            crop = check("Cityscapes Hausdorff", preds[:, :h, :w], target[:, :h, :w], CITY_CLASSES)
    value, compute_ms = _timed(city.compute)
    res["cityscapes"] = {"maps": CITY_HD_MAPS, "shape": list(CITY_SHAPE), "value": float(value),
                         "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
                         "compute_ms": compute_ms, "peak_device_mb": _peak_mb(base), "cpu_crop": list(CITY_CROP),
                         **crop}
    brats = HausdorffDistance(num_classes=4, input_format="index", device="cuda")
    update_ms = []
    base = _reset_peak()
    for i in range(BRATS_HD_VOLUMES):
        preds, target, centre = brats_labels(g)
        update_ms.append(_timed(lambda: brats.update(preds, target))[1])
        if i == 0:
            box = [slice(max(0, c - n // 2), max(0, c - n // 2) + n) for c, n in zip(centre, BRATS_HD_CROP)]
            crop = check("BraTS Hausdorff", preds[(slice(None), *box)], target[(slice(None), *box)], 4)
    value, compute_ms = _timed(brats.compute)
    res["brats"] = {"volumes": BRATS_HD_VOLUMES, "shape": list(BRATS_SHAPE), "value": float(value),
                    "first_update_ms": update_ms[0], "later_update_ms_median": _median_ms(update_ms),
                    "compute_ms": compute_ms, "peak_device_mb": _peak_mb(base), "cpu_crop": list(BRATS_HD_CROP),
                    **crop}
    if not all(0.0 < r["value"] < float("inf") for r in res.values()):
        fail(f"Hausdorff: values out of (0, inf): { {k: r['value'] for k, r in res.items()} }")
    log(f"Cityscapes and BraTS Hausdorff: {json.dumps(res)}")
    return res


def measure_vif_scales(seed: int) -> list:
    """The window kernel alone (cold L2) at each VIF scale's two launches at the LIVE path's size (200 pairs,
    luminance): the low-pass of preds and target together (scales 1-3) and the five statistics."""
    from metrics_tpu_torch.functional.image._helpers import _gaussian_taps_np
    from metrics_tpu_torch.ops.profile import flush_buffer, time_ms
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    flush, (h, w), rows = flush_buffer(), LIVE_SHAPE, []
    for scale in range(VIF_SCALES):
        n = 2 ** (4 - scale) + 1
        taps = _gaussian_taps_np(n, n / 5.0)
        row = {"scale": scale, "taps": n}
        if scale > 0:
            x = torch.rand((2 * LIVE_PAIRS, h, w), device="cuda")
            row["low_pass"] = {"planes": list(x.shape), "ms": time_ms(lambda: ssim_window(x, taps, taps), flush=flush)}
            h, w = (h - n + 2) // 2, (w - n + 2) // 2
        x = torch.rand((5 * LIVE_PAIRS, h, w), device="cuda")
        row["statistics"] = {"planes": list(x.shape), "ms": time_ms(lambda: ssim_window(x, taps, taps), flush=flush)}
        rows.append(row)
        del x
    return rows


# ----------------------------------------------------------------------------- phase 4, regression and wrappers
def regression_and_wrappers(seed: int, wrappers: dict, out: dict, imagenet, imagenet_gpu) -> None:
    """The rest of regression and the wrappers on it: the twelve new scalar classes in one collection at 2^22
    samples, QM9-sized multi-output regression through ``MultioutputWrapper``, WMT-sized Kendall tau, CSI on
    SEVIR-sized nowcasts, KL divergence over ImageNet-1k softmax outputs, cosine similarity of BERT-base-wide
    embeddings; then the wrappers: per-class COCO-80 AP and ImageNet accuracy, both input transformers around
    the binary AUROC, ``MetricTracker`` over the ImageNet collection, ``MinMaxMetric`` and ``MultitaskWrapper``.
    Each against the port's CPU run of the same inputs or of a stated subset, or (Kendall) against scipy."""

    def counting(name, expect, body, check=None):
        """``body()`` between the launch counts; ``check(result, pending)`` after them, for a comparison
        whose own launches are not the path's (``body`` then returns ``(result, pending)``)."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = section(name, body)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        if check is not None:
            result, pending = result
            check(name, result, pending)
        result.update({"launches": launches, "expected_launches": expect})
        out[name] = result

    g = _generator(seed + 11)
    # log-normal demand (log y ~ N(3, 1)); predictions off by a log-normal factor of spread 0.2
    y = torch.exp(3.0 + torch.randn(REG_ALL_N, generator=g, device="cuda"))
    x = y * torch.exp(0.2 * torch.randn(REG_ALL_N, generator=g, device="cuda"))
    counting("regression collection[16 metrics, 2^22 log-normal]", {}, lambda: scalar_regression(x, y))
    counting("QM9 MultioutputWrapper[R2, MAE; 12 targets]", {}, lambda: qm9_multioutput(seed))
    counting("WMT segment-level Kendall tau", {}, lambda: kendall_wmt(seed))
    counting("SEVIR CSI[74, 133]", {}, lambda: sevir_csi(seed))
    counting("ImageNet KL divergence[teacher, student]", {}, lambda: kl_imagenet(seed, imagenet_gpu))
    counting("BERT-base cosine similarity", {}, lambda: cosine_embeddings(seed))
    counting("COCO-80 ClasswiseWrapper[MultilabelAveragePrecision]", {"binned_counts": PRC_STEPS},
             lambda: classwise_coco(seed), check=_check_classwise_coco)
    counting("ImageNet ClasswiseWrapper[MulticlassAccuracy]", {}, lambda: classwise_imagenet(imagenet, imagenet_gpu))
    for name in ("LambdaInputTransformer[BinaryAUROC]", "BinaryTargetTransformer[BinaryAUROC]"):
        counting(name, {"binned_counts": PRC_STEPS}, lambda name=name: input_transformer(seed, name),
                 check=_check_input_transformer)
    counting("ImageNet MetricTracker[3 epochs]", {}, lambda: tracker_imagenet(imagenet, imagenet_gpu))
    counting("MinMaxMetric[MeanSquaredError]", {}, lambda: minmax_regression(x, y))
    counting("MultitaskWrapper[ImageNet accuracy, MSE]", {}, lambda: multitask(imagenet, imagenet_gpu, x, y))


def _updates_timed(metric, batches_gpu):
    """Each update between two synchronizations; (first ms, median later ms)."""
    times = [_timed(lambda: metric.update(*b))[1] for b in batches_gpu]
    return {"updates": len(times), "first_update_ms": times[0], "later_update_ms_median": _median_ms(times)}


def scalar_regression(x, y) -> dict:
    """The twelve new scalar classes with MSE, MAE, Pearson and Spearman in one collection."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch import regression as tr

    def members(d):
        return {"MSLE": tr.MeanSquaredLogError(device=d), "MAPE": tr.MeanAbsolutePercentageError(device=d),
                "SMAPE": tr.SymmetricMeanAbsolutePercentageError(device=d),
                "WMAPE": tr.WeightedMeanAbsolutePercentageError(device=d), "LogCosh": tr.LogCoshError(device=d),
                "Minkowski[p=3]": tr.MinkowskiDistance(p=3, device=d),
                "Tweedie[1.5]": tr.TweedieDevianceScore(power=1.5, device=d),
                "NRMSE[mean]": tr.NormalizedRootMeanSquaredError(normalization="mean", device=d),
                "R2": tr.R2Score(device=d), "RSE": tr.RelativeSquaredError(device=d),
                "ExplainedVariance": tr.ExplainedVariance(device=d), "Concordance": tr.ConcordanceCorrCoef(device=d),
                "MSE": tr.MeanSquaredError(device=d), "MAE": tr.MeanAbsoluteError(device=d),
                "Pearson": tr.PearsonCorrCoef(device=d), "Spearman": tr.SpearmanCorrCoef(device=d)}

    gpu, cpu = MetricCollection(members("cuda")), MetricCollection(members("cpu"))
    batches = [(x[i:i + REG_UPDATE], y[i:i + REG_UPDATE]) for i in range(0, REG_ALL_N, REG_UPDATE)]
    res = _updates_timed(gpu, batches)
    got, res["compute_ms"] = _timed(gpu.compute)
    for xb, yb in batches:
        cpu.update(xb.cpu(), yb.cpu())
    want = cpu.compute()
    if gpu.compute_groups != cpu.compute_groups:
        fail(f"regression collection: compute groups {gpu.compute_groups} on the card, {cpu.compute_groups} on the"
             " CPU")
    res["compute_groups"] = gpu.compute_groups
    res["max_abs_diff_vs_cpu"] = {k: _agree(f"regression collection[{k}]", got[k], want[k], False,
                                            CORR_RTOL if k in ("Pearson", "Spearman", "Concordance") else SUM_RTOL,
                                            SUM_ATOL) for k in want}
    res["value"] = {k: float(v) for k, v in got.items()}
    log(f"regression collection: {json.dumps(res)}")
    return res


def qm9_multioutput(seed: int) -> dict:
    """``MultioutputWrapper`` over R2 and MAE at QM9's size and target count, against the multi-output metrics
    on the card and the CPU run; then the missing-label run (1 % NaN targets) against each column's R2 over
    its rows without a NaN."""
    from metrics_tpu_torch import regression as tr
    from metrics_tpu_torch.functional.regression import r2_score
    from metrics_tpu_torch.wrappers import MultioutputWrapper

    g = _generator(seed + 12)
    n, k = QM9_MOLECULES, QM9_TARGETS
    scale = torch.logspace(-2, 3, k, device="cuda")  # targets of units that differ by five orders
    y = (2.0 + torch.randn(n, k, generator=g, device="cuda")) * scale
    x = y + 0.2 * scale * torch.randn(n, k, generator=g, device="cuda")
    batches = [(x[i:i + QM9_UPDATE], y[i:i + QM9_UPDATE]) for i in range(0, n, QM9_UPDATE)]
    res = {}
    for name, make, whole in (
        ("R2Score", lambda d: tr.R2Score(device=d), lambda d: tr.R2Score(num_outputs=k, multioutput="raw_values",
                                                                          device=d)),
        ("MeanAbsoluteError", lambda d: tr.MeanAbsoluteError(device=d),
         lambda d: tr.MeanAbsoluteError(num_outputs=k, device=d)),
    ):
        gpu, cpu, direct = MultioutputWrapper(make("cuda"), k), MultioutputWrapper(make("cpu"), k), whole("cuda")
        row = _updates_timed(gpu, batches)
        got, row["compute_ms"] = _timed(gpu.compute)
        for xb, yb in batches:
            direct.update(xb, yb)
            cpu.update(xb.cpu(), yb.cpu())
        row["max_abs_diff_vs_multi_output_metric"] = _agree(f"QM9 {name}", got, direct.compute().cpu(), False,
                                                            STAT_RTOL, STAT_ATOL)
        row["max_abs_diff_vs_cpu"] = _agree(f"QM9 {name}[cpu]", got, cpu.compute(), False, STAT_RTOL, STAT_ATOL)
        res[name] = row
    y_nan = torch.where(torch.rand(n, k, generator=g, device="cuda") < QM9_NAN, torch.nan, y)
    gpu = MultioutputWrapper(tr.R2Score(device="cuda"), k, remove_nans=True)
    row = _updates_timed(gpu, [(x[i:i + QM9_UPDATE], y_nan[i:i + QM9_UPDATE]) for i in range(0, n, QM9_UPDATE)])
    got, row["compute_ms"] = _timed(gpu.compute)
    keep = ~torch.isnan(y_nan)
    want = torch.stack([r2_score(x[keep[:, i], i], y_nan[keep[:, i], i]) for i in range(k)]).cpu()
    row["kept_rows"] = [int(m.total) for m in gpu.metrics]
    if row["kept_rows"] != keep.sum(0).tolist():
        fail("QM9 remove_nans: an output's metric did not see exactly its rows without a NaN")
    row["max_abs_diff_vs_filtered_columns"] = _agree("QM9 R2Score[remove_nans]", got, want, False, STAT_RTOL,
                                                     STAT_ATOL)
    res["R2Score[remove_nans, 1 % NaN]"] = row
    log(f"QM9 MultioutputWrapper: {json.dumps(res)}")
    return res


def kendall_wmt(seed: int) -> dict:
    """Kendall tau b (with the t-test's p-value) and c of metric scores against human ratings on the 0-100
    grid, against scipy on every pair and the port's CPU run on the first 8,192."""
    from scipy import stats

    from metrics_tpu_torch.regression import KendallRankCorrCoef

    rng = np.random.default_rng(seed + 13)
    human = rng.integers(0, 101, KENDALL_N).astype(np.float32)
    score = (human / 100 + 0.35 * rng.standard_normal(KENDALL_N)).astype(np.float32)
    score_gpu, human_gpu = torch.from_numpy(score).cuda(), torch.from_numpy(human).cuda()
    pairs = [(score_gpu[i:i + KENDALL_UPDATE], human_gpu[i:i + KENDALL_UPDATE])
             for i in range(0, KENDALL_N, KENDALL_UPDATE)]
    res = {}
    for variant in ("b", "c"):
        def make(d, variant=variant):
            return KendallRankCorrCoef(variant=variant, t_test=variant == "b", device=d)

        gpu = make("cuda")
        row = _updates_timed(gpu, pairs)
        torch.cuda.reset_peak_memory_stats()
        got, row["compute_ms"] = _timed(gpu.compute)
        row["compute_peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
        tau = got[0] if variant == "b" else got
        want = stats.kendalltau(score, human, variant=variant)[0]
        row["tau"], row["scipy_tau"] = float(tau), float(want)
        row["abs_diff_vs_scipy"] = abs(float(tau) - float(want))
        if not row["abs_diff_vs_scipy"] <= KENDALL_ATOL:
            fail(f"Kendall tau-{variant}: {float(tau)} on the card, {float(want)} from scipy")
        head_gpu, head_cpu = make("cuda"), make("cpu")
        head_gpu.update(score_gpu[:KENDALL_CPU_N], human_gpu[:KENDALL_CPU_N])
        head_cpu.update(torch.from_numpy(score[:KENDALL_CPU_N]), torch.from_numpy(human[:KENDALL_CPU_N]))
        row["max_abs_diff_vs_cpu_first_8192"] = _agree(f"Kendall tau-{variant}[first 8192]", head_gpu.compute(),
                                                       head_cpu.compute(), True)
        if variant == "b":
            row["p_value"] = float(got[1])
        res[f"tau-{variant}"] = row
    log(f"WMT Kendall: {json.dumps(res)}")
    return res


def _vil_frames(g: torch.Generator, b: int):
    """VIL-like nowcasts of (b, 12, 384, 384): smooth fields in [0, 255) (bilinear from a 24 x 24 grid, squared
    to make storms rare), the forecast moved by a few pixels with noise."""
    coarse = torch.rand(b, SEVIR_LEAD, 24, 24, generator=g, device="cuda")
    target = 255.0 * F.interpolate(coarse, size=(SEVIR_FRAME, SEVIR_FRAME), mode="bilinear") ** 2
    noise = 12.0 * torch.randn(target.shape, generator=g, device="cuda")
    return (torch.roll(target, shifts=(3, -2), dims=(2, 3)) + noise).clamp(0, 254.0), target


def sevir_csi(seed: int) -> dict:
    """CSI at VIL 74 and 133, summed and per lead time, over 256 sequences; the counts of the first 32 equal to
    the CPU run's."""
    from metrics_tpu_torch.regression import CriticalSuccessIndex

    g = _generator(seed + 14)

    def make(d):
        return {f"{int(t)}{'[per lead time]' if keep else ''}": CriticalSuccessIndex(t, keep_sequence_dim=keep,
                                                                                     device=d)
                for t in SEVIR_THRESHOLDS for keep in (None, 1)}

    gpu, cpu = make("cuda"), make("cpu")
    times, head = [], None
    cpu_updates = SEVIR_CPU_SEQS // SEVIR_UPDATE
    for u in range(SEVIR_SEQS // SEVIR_UPDATE):
        preds, target = _vil_frames(g, SEVIR_UPDATE)
        times.append(_timed(lambda: [m.update(preds, target) for m in gpu.values()])[1])
        if u < cpu_updates:
            pc, tcpu = preds.cpu(), target.cpu()
            for m in cpu.values():
                m.update(pc, tcpu)
        if u == cpu_updates - 1:  # the card's counts after the first 32 sequences
            head = {k: {s: [v.clone() for v in m.metric_state[s]] if isinstance(m.metric_state[s], list)
                        else m.metric_state[s].clone() for s in ("hits", "misses", "false_alarms")}
                    for k, m in gpu.items()}
    for name, states in head.items():
        for key, value in states.items():
            want = cpu[name].metric_state[key]
            got = torch.cat(value).cpu() if isinstance(value, list) else value.cpu()
            want = torch.cat(want) if isinstance(want, list) else want
            if not torch.equal(got, want):
                fail(f"SEVIR CSI {name}: {key} of the first 32 sequences differ from the CPU run")
    res = {"updates": len(times), "first_update_ms": times[0], "later_update_ms_median": _median_ms(times)}
    values, res["compute_ms"] = _timed(lambda: {k: m.compute() for k, m in gpu.items()})
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            fail(f"SEVIR CSI {name}: non-finite values")
    res["value"] = {k: float(v) for k, v in values.items() if v.numel() == 1}
    res["per_lead_time_shape"] = {k: list(v.shape) for k, v in values.items() if v.numel() > 1}
    res["hits"] = {k: int(m.hits.sum()) if not isinstance(m.hits, list) else int(torch.cat(m.hits).sum())
                   for k, m in gpu.items()}
    log(f"SEVIR CSI: {json.dumps(res)}")
    return res


def kl_imagenet(seed: int, imagenet_gpu) -> dict:
    """KL divergence of a student's softmax from the teacher's over the ImageNet-1k logits, as probabilities and
    as log-probabilities, against the CPU run."""
    from metrics_tpu_torch.regression import KLDivergence

    g = _generator(seed + 15)
    teacher_student = []
    for logits, _ in imagenet_gpu:
        student = 0.8 * logits + torch.randn(logits.shape, generator=g, device="cuda")
        teacher_student.append((logits, student))
    res = {}
    for log_prob in (False, True):
        norm = torch.log_softmax if log_prob else torch.softmax
        batches = [(norm(t, dim=-1), norm(s, dim=-1)) for t, s in teacher_student]
        gpu, cpu = KLDivergence(log_prob=log_prob, device="cuda"), KLDivergence(log_prob=log_prob, device="cpu")
        row = _updates_timed(gpu, batches)
        got, row["compute_ms"] = _timed(gpu.compute)
        for p, q in batches:
            cpu.update(p.cpu(), q.cpu())
        row["value"] = float(got)
        row["max_abs_diff_vs_cpu"] = _agree(f"KL[log_prob={log_prob}]", got, cpu.compute(), False, SUM_RTOL, SUM_ATOL)
        res[f"log_prob={log_prob}"] = row
    log(f"ImageNet KL divergence: {json.dumps(res)}")
    return res


def cosine_embeddings(seed: int) -> dict:
    """Mean cosine similarity of 50,000 pairs of 768-wide embeddings, against the CPU run."""
    from metrics_tpu_torch.regression import CosineSimilarity

    g = _generator(seed + 16)
    a = torch.randn(EMB_N, EMB_DIM, generator=g, device="cuda")
    b = a + 0.6 * torch.randn(EMB_N, EMB_DIM, generator=g, device="cuda")
    batches = [(a[i:i + EMB_UPDATE], b[i:i + EMB_UPDATE]) for i in range(0, EMB_N, EMB_UPDATE)]
    gpu, cpu = CosineSimilarity(reduction="mean", device="cuda"), CosineSimilarity(reduction="mean", device="cpu")
    res = _updates_timed(gpu, batches)
    got, res["compute_ms"] = _timed(gpu.compute)
    for p, t in batches:
        cpu.update(p.cpu(), t.cpu())
    res["value"] = float(got)
    res["max_abs_diff_vs_cpu"] = _agree("cosine similarity", got, cpu.compute(), False, SUM_RTOL, SUM_ATOL)
    log(f"BERT-base cosine similarity: {json.dumps(res)}")
    return res


def classwise_coco(seed: int) -> dict:
    """Per-class AP over the 80 COCO labels under their names; the values the unwrapped metric's (its run, on
    the same batches, is outside the launch count)."""
    from metrics_tpu_torch.classification import MultilabelAveragePrecision
    from metrics_tpu_torch.wrappers import ClasswiseWrapper

    rng = np.random.default_rng(seed + 17)
    batches = []
    for _ in range(PRC_STEPS):
        target = (rng.random((ML_N, ML_LABELS)) < ML_POSITIVE).astype(np.int64)
        preds = ((rng.random((ML_N, ML_LABELS), dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        batches.append((torch.from_numpy(preds).cuda(), torch.from_numpy(target).cuda()))

    def make():
        return MultilabelAveragePrecision(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, average=None,
                                          device="cuda")

    wrapped = ClasswiseWrapper(make(), labels=COCO_NAMES)
    res = _updates_timed(wrapped, batches)
    got, res["compute_ms"] = _timed(wrapped.compute)
    return res, (got, batches, make)


def _check_classwise_coco(name: str, row: dict, pending) -> None:
    """The unwrapped metric on the same batches."""
    got, batches, make = pending
    plain = make()
    for p, t in batches:
        plain.update(p, t)
    want = plain.compute()
    if list(got) != [f"multilabelaverageprecision_{name}" for name in COCO_NAMES]:
        fail("COCO-80 ClasswiseWrapper: keys are not the 80 category names")
    if not torch.equal(torch.stack(list(got.values())), want):
        fail("COCO-80 ClasswiseWrapper: values differ from the unwrapped metric's")
    row["values_equal_unwrapped"] = True
    row["mean_ap"] = float(want.mean())


def classwise_imagenet(imagenet, imagenet_gpu) -> dict:
    """Per-class top-1 accuracy over the 1000 ImageNet classes, against the CPU run."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.wrappers import ClasswiseWrapper

    gpu, cpu = (ClasswiseWrapper(MulticlassAccuracy(num_classes=IN_CLASSES, average=None, device=d))
                for d in ("cuda", "cpu"))
    res = _updates_timed(gpu, imagenet_gpu)
    got, res["compute_ms"] = _timed(gpu.compute)
    for p, t in imagenet:
        cpu.update(p, t)
    res["classes"] = len(got)
    res["max_abs_diff_vs_cpu"] = _agree_dict("ImageNet ClasswiseWrapper", got, cpu.compute(), True, STAT_RTOL,
                                             STAT_ATOL)
    return res


def input_transformer(seed: int, name: str) -> dict:
    """A transformer around BinaryAUROC on 2^22 binary samples an update; its value the unwrapped metric's on the
    transformed inputs (run outside the launch count)."""
    from metrics_tpu_torch.classification import BinaryAUROC
    from metrics_tpu_torch.wrappers import BinaryTargetTransformer, LambdaInputTransformer

    g = _generator(seed + 18)
    batches = []
    for _ in range(PRC_STEPS):
        labels = (torch.rand(BIN_N, generator=g, device="cuda") < 0.5).long()
        if name.startswith("Lambda"):  # logits in, probabilities to the metric
            batches.append((torch.randn(BIN_N, generator=g, device="cuda") + 1.5 * labels, labels))
        else:  # soft labels in [0, 1), thresholded at 0.5
            soft = 0.5 * labels + 0.5 * torch.rand(BIN_N, generator=g, device="cuda")
            batches.append((torch.rand(BIN_N, generator=g, device="cuda") * 0.7 + 0.3 * labels, soft))
    if name.startswith("Lambda"):
        wrapper = LambdaInputTransformer(BinaryAUROC(thresholds=PRC_THRESHOLDS, device="cuda"),
                                         transform_pred=torch.sigmoid)
    else:
        wrapper = BinaryTargetTransformer(BinaryAUROC(thresholds=PRC_THRESHOLDS, device="cuda"), threshold=0.5)
    res = _updates_timed(wrapper, batches)
    got, res["compute_ms"] = _timed(wrapper.compute)
    return res, (got, [(wrapper.transform_pred(p), wrapper.transform_target(t)) for p, t in batches])


def _check_input_transformer(name: str, row: dict, pending) -> None:
    """The unwrapped metric on the transformed inputs."""
    from metrics_tpu_torch.classification import BinaryAUROC

    got, transformed = pending
    plain = BinaryAUROC(thresholds=PRC_THRESHOLDS, device="cuda")
    for p, t in transformed:
        plain.update(p, t)
    if not torch.equal(got, plain.compute()):
        fail(f"{name}: {float(got)}, the unwrapped metric on the transformed inputs {float(plain.compute())}")
    row["value"] = float(got)
    row["equal_unwrapped_on_transformed_inputs"] = True


def tracker_imagenet(imagenet, imagenet_gpu) -> dict:
    """``MetricTracker`` over the ImageNet collection for 3 epochs of 2 updates, against the CPU run's values
    and best steps (the confusion matrix has no best step: None in both)."""
    import warnings

    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.wrappers import MetricTracker

    gpu = MetricTracker(MetricCollection(imagenet_members("cuda")))
    cpu = MetricTracker(MetricCollection(imagenet_members("cpu")))
    order = [(e * TRACK_UPDATES + u) % len(imagenet) for e in range(TRACK_EPOCHS) for u in range(TRACK_UPDATES)]
    times = []
    for e in range(TRACK_EPOCHS):
        gpu.increment()
        cpu.increment()
        for u in range(TRACK_UPDATES):
            i = order[e * TRACK_UPDATES + u]
            times.append(_timed(lambda: gpu.update(*imagenet_gpu[i]))[1])
            cpu.update(*imagenet[i])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the confusion matrix is not one scalar a step: None, with a warning
        (best, steps), ms = _timed(lambda: gpu.best_metric(return_step=True))
        want_best, want_steps = cpu.best_metric(return_step=True)
    if steps != want_steps:
        fail(f"MetricTracker: best steps {steps} on the card, {want_steps} on the CPU")
    for key, value in want_best.items():
        if (value is None) != (best[key] is None) or (
                value is not None and abs(float(best[key]) - float(value)) > STAT_RTOL * abs(float(value)) + STAT_ATOL):
            fail(f"MetricTracker: best {key} {best[key]} on the card, {value} on the CPU")
    res = {"updates": len(times), "first_update_ms": times[0], "later_update_ms_median": _median_ms(times),
           "compute_ms": ms, "best_step": steps, "best": {k: None if v is None else float(v) for k, v in best.items()}}
    all_gpu, all_cpu = gpu.compute_all(), cpu.compute_all()
    res["max_abs_diff_vs_cpu"] = _agree_dict("MetricTracker.compute_all", all_gpu, all_cpu, True, STAT_RTOL,
                                             STAT_ATOL)
    return res


def minmax_regression(x, y) -> dict:
    """``MinMaxMetric(MeanSquaredError())`` over the 16 regression updates of 2^18, against the CPU run."""
    from metrics_tpu_torch.regression import MeanSquaredError
    from metrics_tpu_torch.wrappers import MinMaxMetric

    gpu, cpu = MinMaxMetric(MeanSquaredError(device="cuda")), MinMaxMetric(MeanSquaredError(device="cpu"))
    batches = [(x[i:i + REG_UPDATE], y[i:i + REG_UPDATE]) for i in range(0, REG_ALL_N, REG_UPDATE)]
    res = _updates_timed(gpu, batches)
    got, res["compute_ms"] = _timed(gpu.compute)
    for xb, yb in batches:
        cpu.update(xb.cpu(), yb.cpu())
    res["value"] = {k: float(v) for k, v in got.items()}
    res["max_abs_diff_vs_cpu"] = _agree_dict("MinMaxMetric", got, cpu.compute(), False, SUM_RTOL, SUM_ATOL)
    return res


def multitask(imagenet, imagenet_gpu, x, y) -> dict:
    """``MultitaskWrapper`` of ImageNet top-1 accuracy and the regression MSE, against the CPU run."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.regression import MeanSquaredError
    from metrics_tpu_torch.wrappers import MultitaskWrapper

    def make(d):
        return MultitaskWrapper({"cls": MulticlassAccuracy(num_classes=IN_CLASSES, device=d),
                                 "reg": MeanSquaredError(device=d)})

    gpu, cpu = make("cuda"), make("cpu")
    regs = [(x[i * REG_UPDATE:(i + 1) * REG_UPDATE], y[i * REG_UPDATE:(i + 1) * REG_UPDATE])
            for i in range(len(imagenet))]
    inputs = [({"cls": p, "reg": xr}, {"cls": t, "reg": yr}) for (p, t), (xr, yr) in zip(imagenet_gpu, regs)]
    res = _updates_timed(gpu, inputs)
    got, res["compute_ms"] = _timed(gpu.compute)
    for (p, t), (xr, yr) in zip(imagenet, regs):
        cpu.update({"cls": p, "reg": xr.cpu()}, {"cls": t, "reg": yr.cpu()})
    res["value"] = {k: float(v) for k, v in got.items()}
    res["max_abs_diff_vs_cpu"] = _agree_dict("MultitaskWrapper", got, cpu.compute(), False, SUM_RTOL, SUM_ATOL)
    return res


# ----------------------------------------------------------------------------- phase 4, pairwise to shape, runtime
def pairwise_clustering_nominal_shape(seed: int, wrappers: dict, out: dict) -> None:
    """Pairwise distances at CIFAR-10 k-NN scale, the nine label clustering metrics at ImageNet-1k train scale
    (AMI's expected mutual information over about 1.3e9 terms), the embedding clustering metrics on ResNet-50
    pooled features, the nominal association of UCI Adult's nine categorical columns, Fleiss' kappa at CIFAR-10H
    scale, Procrustes disparity over Human3.6M-sized poses, then the runtime's leftovers (``to_device``,
    ``state_fingerprint``, the forward-state check, ``plot``). None of them launches a kernel; each is checked
    against the port's CPU run of a stated subset."""

    def counting(name, body):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = section(name, body)
        torch.cuda.synchronize()
        result.update({"launches": {k: w.launches for k, w in wrappers.items()}, "expected_launches": {}})
        out[name] = result

    counting("CIFAR-10 k-NN pairwise distances", lambda: cifar_knn_pairwise(seed))
    counting("ImageNet-1k extrinsic clustering[9 label metrics]", lambda: imagenet_label_clustering(seed))
    counting("ResNet-50 embedding clustering[CH, DB, Dunn p=2, p=1]", lambda: embedding_clustering(seed))
    counting("UCI Adult nominal association", lambda: adult_nominal(seed))
    counting("CIFAR-10H Fleiss kappa", lambda: cifar10h_fleiss(seed))
    counting("Human3.6M-sized Procrustes disparity", lambda: pose_procrustes(seed))
    counting("runtime: to_device, state_fingerprint, forward-state check, plot", lambda: runtime_leftovers(seed))


def cifar_knn_pairwise(seed: int) -> dict:
    """Cosine, euclidean and linear similarity of the 10,000 test against the 50,000 train embeddings (a 2 GB
    matrix) with each reduction, and the manhattan and Minkowski (p = 3) distances of the test embeddings
    against themselves, in blocks of rows; ``torch.cdist`` of the same is timed beside them (a library call the
    port does not use). The embeddings are ReLU features around 10 class centres: the nearest train embedding's
    class is the test embedding's for most of them."""
    from metrics_tpu_torch import functional as tf

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the float32 products would lose their float32 meaning")
    g = _generator(seed + 30)
    centres = torch.randn(KNN_CLASSES, KNN_DIM, generator=g, device="cuda")

    def embed(n):
        labels = torch.randint(0, KNN_CLASSES, (n,), generator=g, device="cuda")
        return torch.relu(centres[labels] + 1.5 * torch.randn(n, KNN_DIM, generator=g, device="cuda")), labels

    test, test_labels = embed(KNN_TEST)
    train, train_labels = embed(KNN_TRAIN)
    ct, cr = KNN_CPU
    res = {"test": KNN_TEST, "train": KNN_TRAIN, "dim": KNN_DIM, "cpu_check": [ct, cr], "ms": {},
           "peak_device_mb": {}, "max_abs_diff_vs_cpu": {}}

    def check(key, fn, full, x_cpu, y_cpu, x_gpu, y_gpu, **kw):
        want = fn(x_cpu, y_cpu, **kw)
        diff = _agree(f"pairwise {key}", fn(x_gpu, y_gpu, **kw), want, False, PAIR_RTOL, PAIR_ATOL)
        if full is not None:  # the full matrix's corner is the subset's matrix
            diff = max(diff, _agree(f"pairwise {key}[corner]", full[:ct, :cr].contiguous(), want, False,
                                    PAIR_RTOL, PAIR_ATOL))
        res["max_abs_diff_vs_cpu"][key] = diff

    for name in ("cosine_similarity", "euclidean_distance", "linear_similarity"):
        fn = getattr(tf, f"pairwise_{name}")
        for reduction in (None, "mean", "sum"):
            key = f"{name}[{reduction}]"
            base = _reset_peak()
            got, res["ms"][key] = _timed(lambda: fn(test, train, reduction=reduction))
            res["peak_device_mb"][key] = _peak_mb(base)
            want_shape = (KNN_TEST, KNN_TRAIN) if reduction is None else (KNN_TEST,)
            if tuple(got.shape) != want_shape or not bool(torch.isfinite(got).all()):
                fail(f"pairwise {key}: shape {tuple(got.shape)} or non-finite values")
            if reduction is None:
                nearest = got.argmin(1) if name == "euclidean_distance" else got.argmax(1)
                res[f"{name}_1nn_accuracy"] = float((train_labels[nearest] == test_labels).float().mean())
                if res[f"{name}_1nn_accuracy"] < 0.5:
                    fail(f"pairwise {key}: 1-NN accuracy {res[f'{name}_1nn_accuracy']} over 10 classes")
            check(key, fn, got if reduction is None else None, test[:ct].cpu(), train[:cr].cpu(), test[:ct],
                  train[:cr], reduction=reduction)
            del got
    for name, kw, p in (("manhattan_distance", {}, 1.0), ("minkowski_distance", {"exponent": 3}, 3.0)):
        fn = getattr(tf, f"pairwise_{name}")
        base = _reset_peak()
        got, res["ms"][name] = _timed(lambda: fn(test, **kw))
        res["peak_device_mb"][name] = _peak_mb(base)
        lib, res["ms"][f"{name}[torch.cdist]"] = _timed(lambda: torch.cdist(test, test, p=p))
        lib.fill_diagonal_(0.0)
        res["max_rel_diff_vs_cdist"] = max(res.get("max_rel_diff_vs_cdist", 0.0),
                                           float(((got - lib).abs() / lib.clamp(min=1e-6)).max()))
        del lib
        if tuple(got.shape) != (KNN_TEST, KNN_TEST) or not bool(torch.isfinite(got).all()):
            fail(f"pairwise {name}: shape {tuple(got.shape)} or non-finite values")
        check(name, fn, got, test[:ct].cpu(), test[:cr].cpu(), test[:ct], test[:cr], **kw)
        del got
    log(f"CIFAR-10 k-NN pairwise: {json.dumps(res)}")
    return res


def _cluster_labels(g: torch.Generator, n: int, purity: torch.Tensor, perm: torch.Tensor):
    """(cluster ids, class labels) of ``n`` images on the card: uniform classes over 1,000; each image keeps its
    class's cluster with its class's purity and falls into a uniform cluster otherwise; the cluster ids are a
    permutation of the class ids."""
    target = torch.randint(0, 1000, (n,), generator=g, device="cuda")
    keep = torch.rand(n, generator=g, device="cuda") < purity[target]
    noise = torch.randint(0, 1000, (n,), generator=g, device="cuda")
    return perm[torch.where(keep, target, noise)], target


LABEL_METRICS = ("MutualInfoScore", "RandScore", "AdjustedRandScore", "FowlkesMallowsIndex", "HomogeneityScore",
                 "CompletenessScore", "VMeasureScore", "NormalizedMutualInfoScore", "AdjustedMutualInfoScore")


def imagenet_label_clustering(seed: int) -> dict:
    """The nine label metrics in one collection over the 1,281,167 ImageNet-1k train labels against 1,000
    clusters (class purities uniform in [0.2, 0.9]), updates of 2^17; each compute timed alone, AMI's expected
    mutual information timed alone with its terms counted and its peak memory. CPU check: the same metrics at
    the 50,000-image validation scale."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch import clustering as tcl
    from metrics_tpu_torch.functional.clustering import extrinsic as tx

    g = _generator(seed + 31)
    purity = 0.2 + 0.7 * torch.rand(1000, generator=g, device="cuda")
    perm = torch.randperm(1000, generator=g, device="cuda")

    def make(device):
        return MetricCollection({n: getattr(tcl, n)(device=device) for n in LABEL_METRICS})

    preds, target = _cluster_labels(g, IN_TRAIN, purity, perm)
    gpu = make("cuda")
    batches = [(preds[i:i + CLUSTER_UPDATE], target[i:i + CLUSTER_UPDATE]) for i in range(0, IN_TRAIN, CLUSTER_UPDATE)]
    res = _updates_timed(gpu, batches)
    res.update({"labels": IN_TRAIN, "clusters": 1000, "classes": 1000, "compute_ms": {}, "values": {}})
    for name in LABEL_METRICS:
        base = _reset_peak()
        value, res["compute_ms"][name] = _timed(gpu[name].compute)
        if name == "AdjustedMutualInfoScore":
            res["ami_compute_peak_device_mb"] = _peak_mb(base)
        if not bool(torch.isfinite(value)):
            fail(f"ImageNet clustering {name}: {float(value)}")
        res["values"][name] = float(value)
    c = tx.calculate_contingency_matrix(preds, target)
    a, b, n = c.sum(1).long(), c.sum(0).long(), IN_TRAIN
    spans = torch.minimum(a[:, None], b[None, :]) - torch.clamp(a[:, None] + b[None, :] - n, min=1) + 1
    res["emi_terms"] = int(spans.sum())
    base = _reset_peak()
    emi, res["emi_ms"] = _timed(lambda: tx._expected_mutual_info(c))
    res["emi_peak_device_mb"] = _peak_mb(base)
    res["emi"] = float(emi)
    if not 0.0 < res["values"]["NormalizedMutualInfoScore"] < 1.0 or not math.isfinite(res["emi"]):
        fail(f"ImageNet clustering: NMI {res['values']['NormalizedMutualInfoScore']}, EMI {res['emi']}")
    del preds, target, batches, c, spans
    vp, vt = _cluster_labels(g, IN_VAL, purity, perm)
    gpu_val, cpu_val = make("cuda"), make("cpu")
    gpu_val.update(vp, vt)
    cpu_val.update(vp.cpu(), vt.cpu())
    got, want = gpu_val.compute(), cpu_val.compute()
    res["max_abs_diff_vs_cpu"] = {k: _agree(f"ImageNet val clustering {k}", got[k], want[k], False,
                                            AMI_RTOL if k == "AdjustedMutualInfoScore" else LABEL_RTOL, 0.0)
                                  for k in LABEL_METRICS}
    res["cpu_check_labels"] = IN_VAL
    log(f"ImageNet-1k extrinsic clustering: {json.dumps(res)}")
    return res


def _blob_embeddings(g: torch.Generator, n: int, k: int):
    """(n, 2048) ReLU features around ``k`` cluster centres on the card, and their labels."""
    centres = 0.5 * torch.randn(k, EMBED_DIM, generator=g, device="cuda")
    labels = torch.randint(0, k, (n,), generator=g, device="cuda")
    return torch.relu(centres[labels] + torch.randn(n, EMBED_DIM, generator=g, device="cuda")), labels


def embedding_clustering(seed: int) -> dict:
    """Calinski-Harabasz, Davies-Bouldin and Dunn (p = 2 and p = 1) over 50,000 ResNet-50-wide embeddings with
    1,000 labels, updates of 10,000; each compute timed with its peak memory. CPU check: 5,000 embeddings with
    100 labels through the same metrics."""
    from metrics_tpu_torch import clustering as tcl

    def make(device):
        return {"CalinskiHarabaszScore": tcl.CalinskiHarabaszScore(device=device),
                "DaviesBouldinScore": tcl.DaviesBouldinScore(device=device),
                "DunnIndex[p=2]": tcl.DunnIndex(p=2.0, device=device),
                "DunnIndex[p=1]": tcl.DunnIndex(p=1.0, device=device)}

    g = _generator(seed + 32)
    data, labels = _blob_embeddings(g, EMBED_N, EMBED_K)
    gpu = make("cuda")
    res = {"embeddings": EMBED_N, "dim": EMBED_DIM, "clusters": EMBED_K, "update_ms": {}, "compute_ms": {},
           "peak_device_mb": {}, "values": {}}
    for name, metric in gpu.items():
        res["update_ms"][name] = _updates_timed(metric, [(data[i:i + EMBED_UPDATE], labels[i:i + EMBED_UPDATE])
                                                         for i in range(0, EMBED_N, EMBED_UPDATE)])
        base = _reset_peak()
        value, res["compute_ms"][name] = _timed(metric.compute)
        res["peak_device_mb"][name] = _peak_mb(base)
        if not bool(torch.isfinite(value)) or float(value) <= 0:
            fail(f"embedding clustering {name}: {float(value)}")
        res["values"][name] = float(value)
    del data, labels, gpu
    data, labels = _blob_embeddings(g, EMBED_CPU_N, EMBED_CPU_K)
    gpu, cpu = make("cuda"), make("cpu")
    res["max_abs_diff_vs_cpu"] = {}
    for name in gpu:
        gpu[name].update(data, labels)
        cpu[name].update(data.cpu(), labels.cpu())
        res["max_abs_diff_vs_cpu"][name] = _agree(f"embedding clustering {name}", gpu[name].compute(),
                                                  cpu[name].compute(), False, INTRINSIC_RTOL, 0.0)
    log(f"ResNet-50 embedding clustering: {json.dumps(res)}")
    return res


def adult_table(g: torch.Generator, n: int) -> torch.Tensor:
    """(n, 9) float32 codes of UCI Adult's categorical columns at their cardinalities, each tied in part to a
    shared latent (education, occupation and income move together), 1 % of the cells NaN."""
    latent = torch.randn(n, generator=g, device="cuda")
    cols = []
    for i, k in enumerate(ADULT_CARDS.values()):
        weight = 0.3 + 0.1 * (i % 5)
        mixed = weight * latent + (1 - weight) * torch.randn(n, generator=g, device="cuda")
        cols.append(torch.clamp(((mixed + 2.5) / 5 * k).floor(), 0, k - 1))
    table = torch.stack(cols, dim=1)
    table[torch.rand(table.shape, generator=g, device="cuda") < ADULT_NAN] = float("nan")
    return table


NOMINAL_MATRICES = ("cramers_v_matrix", "tschuprows_t_matrix", "pearsons_contingency_coefficient_matrix",
                    "theils_u_matrix")


def adult_nominal(seed: int) -> dict:
    """The four ``*_matrix`` functions over 2^20 rows of Adult's nine categorical columns under both
    ``nan_strategy``s, and the four classes on (occupation, income) in updates of 2^18; each timed. CPU check:
    the first 2^16 rows through the same functions and classes."""
    import warnings

    from metrics_tpu_torch import functional as tf
    from metrics_tpu_torch import nominal as tno

    g = _generator(seed + 33)
    table = adult_table(g, ADULT_ROWS)
    small, small_cpu = table[:ADULT_CPU_ROWS], table[:ADULT_CPU_ROWS].cpu()
    res = {"rows": ADULT_ROWS, "columns": list(ADULT_CARDS), "ms": {}, "peak_device_mb": {}, "max_abs_diff_vs_cpu": {},
           "values": {}}
    occ, inc = list(ADULT_CARDS).index("occupation"), list(ADULT_CARDS).index("income")
    with warnings.catch_warnings():
        # a NaN from a zero bias-corrected denominator fails the path
        warnings.filterwarnings("error", message="Unable to compute Cramer's V")
        for name in NOMINAL_MATRICES:
            fn = getattr(tf, name)
            for strategy in ("replace", "drop"):
                key = f"{name}[{strategy}]"
                base = _reset_peak()
                got, res["ms"][key] = _timed(lambda: fn(table, nan_strategy=strategy))
                res["peak_device_mb"][key] = _peak_mb(base)
                if tuple(got.shape) != (9, 9) or not bool(torch.isfinite(got).all()):
                    fail(f"Adult {key}: shape {tuple(got.shape)} or non-finite values")
                res["values"][key] = float(got[occ, inc])
                res["max_abs_diff_vs_cpu"][key] = _agree(f"Adult {key}", fn(small, nan_strategy=strategy),
                                                         fn(small_cpu, nan_strategy=strategy), False, NOMINAL_RTOL,
                                                         NOMINAL_ATOL)
        classes = {"CramersV": {"num_classes": 15}, "CramersV[drop]": {"num_classes": 15, "nan_strategy": "drop"},
                   "TschuprowsT": {"num_classes": 15}, "PearsonsContingencyCoefficient": {"num_classes": 15},
                   "TheilsU": {"num_classes": 15}}
        for key, kw in classes.items():
            cls = getattr(tno, key.split("[")[0])
            gpu = cls(device="cuda", **kw)
            res["ms"][f"{key} updates"] = _updates_timed(gpu, [(table[i:i + ADULT_UPDATE, occ],
                                                                 table[i:i + ADULT_UPDATE, inc])
                                                                for i in range(0, ADULT_ROWS, ADULT_UPDATE)])
            value, res["ms"][f"{key} compute"] = _timed(gpu.compute)
            res["values"][key] = float(value)
            part, cpu = cls(device="cuda", **kw), cls(device="cpu", **kw)
            part.update(small[:, occ], small[:, inc])
            cpu.update(small_cpu[:, occ], small_cpu[:, inc])
            res["max_abs_diff_vs_cpu"][key] = _agree(f"Adult {key}", part.compute(), cpu.compute(), False,
                                                     NOMINAL_RTOL, NOMINAL_ATOL)
    log(f"UCI Adult nominal association: {json.dumps(res)}")
    return res


def cifar10h_fleiss(seed: int) -> dict:
    """Fleiss' kappa over 10,000 images x 10 classes x 50 ratings: counts mode in one update, probs mode on
    (10,000, 10, 50) in updates of 1,000. Each rater votes for the image's class with the image's reliability
    (uniform in [0.5, 1]) and uniformly otherwise; the probabilities put each rater's maximum on its vote. Both
    modes equal the single stream of the same votes; CPU check: both modes over the same ratings."""
    from metrics_tpu_torch.functional.nominal import fleiss_kappa
    from metrics_tpu_torch.nominal import FleissKappa

    g = _generator(seed + 34)
    n, k, r = C10H_IMAGES, C10H_CLASSES, C10H_RATERS
    true = torch.randint(0, k, (n, 1), generator=g, device="cuda")
    reliable = torch.rand((n, r), generator=g, device="cuda") < (0.5 + 0.5 * torch.rand((n, 1), generator=g,
                                                                                       device="cuda"))
    votes = torch.where(reliable, true, torch.randint(0, k, (n, r), generator=g, device="cuda"))
    counts = torch.zeros((n, k), device="cuda").scatter_add_(1, votes, torch.ones((n, r), device="cuda"))
    noise = torch.rand((n, k, r), generator=g, device="cuda")
    probs = torch.softmax(noise + 4.0 * F.one_hot(votes, k).transpose(1, 2), dim=1)
    res = {"images": n, "classes": k, "raters": r}
    base = _reset_peak()
    counts_metric, probs_metric = FleissKappa(mode="counts", device="cuda"), FleissKappa(mode="probs", device="cuda")
    res["counts"] = _updates_timed(counts_metric, [(counts,)])
    res["probs"] = _updates_timed(probs_metric, [(probs[i:i + C10H_UPDATE],) for i in range(0, n, C10H_UPDATE)])
    got_counts, res["counts"]["compute_ms"] = _timed(counts_metric.compute)
    got_probs, res["probs"]["compute_ms"] = _timed(probs_metric.compute)
    res["peak_device_mb"] = _peak_mb(base)
    single = fleiss_kappa(probs, "probs")
    if not (torch.equal(got_probs, single) and torch.equal(got_counts, fleiss_kappa(counts, "counts"))
            and torch.equal(got_probs, got_counts)):
        fail(f"Fleiss kappa: probs stream {float(got_probs)}, single {float(single)}, counts {float(got_counts)}")
    res["value"] = float(got_probs)
    if not 0.0 < res["value"] < 1.0:
        fail(f"Fleiss kappa {res['value']} outside (0, 1)")
    res["max_abs_diff_vs_cpu"] = max(
        _agree("Fleiss kappa counts", got_counts, fleiss_kappa(counts.cpu(), "counts"), False, NOMINAL_RTOL, 0.0),
        _agree("Fleiss kappa probs", got_probs, fleiss_kappa(probs.cpu(), "probs"), False, NOMINAL_RTOL, 0.0))
    log(f"CIFAR-10H Fleiss kappa: {json.dumps(res)}")
    return res


def pose_pairs(g: torch.Generator, n: int):
    """(predicted, ground-truth) poses of 17 joints x 3 on the card: the ground truth in metres about the
    pelvis, the prediction that pose rotated, scaled by 0.8-1.2, moved and noised by 2 cm; one pose in 64 is
    degenerate (every predicted joint at one point of quarter-integer coordinates)."""
    gt = 0.3 * torch.randn((n, POSE_JOINTS, 3), generator=g, device="cuda")
    q, rr = torch.linalg.qr(torch.randn((n, 3, 3), generator=g, device="cuda"))
    rot = q * torch.sign(torch.diagonal(rr, dim1=1, dim2=2))[:, None, :]
    scale = 0.8 + 0.4 * torch.rand((n, 1, 1), generator=g, device="cuda")
    move = torch.randn((n, 1, 3), generator=g, device="cuda")
    pred = scale * gt @ rot.transpose(1, 2) + move + 0.02 * torch.randn(gt.shape, generator=g, device="cuda")
    point = torch.randint(-8, 8, (n, 1, 3), generator=g, device="cuda") / 4
    degenerate = torch.arange(n, device="cuda") % POSE_DEGENERATE_EVERY == 0
    pred = torch.where(degenerate[:, None, None], point.expand_as(pred), pred)
    return pred, gt, degenerate


def pose_procrustes(seed: int) -> dict:
    """``ProcrustesDisparity`` over 2^17 poses in updates of 1,024, and ``procrustes_disparity(return_all=True)``
    on one update; the synchronizations ``torch.linalg.svd`` makes, counted by CUDA's sync debug mode. CPU check:
    the first 4,096 poses."""
    import warnings

    from metrics_tpu_torch.functional.shape import procrustes_disparity
    from metrics_tpu_torch.shape import ProcrustesDisparity

    g = _generator(seed + 35)
    pred, gt, degenerate = pose_pairs(g, POSE_N)
    gpu = ProcrustesDisparity(device="cuda")
    base = _reset_peak()
    res = _updates_timed(gpu, [(pred[i:i + POSE_UPDATE], gt[i:i + POSE_UPDATE]) for i in range(0, POSE_N, POSE_UPDATE)])
    value, res["compute_ms"] = _timed(gpu.compute)
    res["peak_device_mb"] = _peak_mb(base)
    res.update({"poses": POSE_N, "joints": POSE_JOINTS, "value": float(value), "degenerate": int(degenerate.sum())})
    b = slice(0, POSE_UPDATE)
    (d, s, rot), res["return_all_ms"] = _timed(lambda: procrustes_disparity(pred[b], gt[b], return_all=True))
    eye = torch.eye(3, device="cuda")
    deg = degenerate[b]
    if not (bool((d[deg] == 0).all()) and bool((s[deg] == 1).all()) and bool((rot[deg] == eye).all())
            and bool((d[~deg] < 0.05).all()) and bool(torch.isfinite(rot).all())):
        fail("Procrustes: degenerate poses not guarded, or a fit beyond the noise")

    def syncs(fn):
        """The synchronizations CUDA's sync debug mode reports during ``fn()``."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)

    res["host_syncs_per_procrustes_call"] = syncs(lambda: procrustes_disparity(pred[b], gt[b]))
    svd_input = torch.randn((POSE_UPDATE, 3, 3), device="cuda")
    res["host_syncs_per_svd_call"] = syncs(lambda: torch.linalg.svd(svd_input, full_matrices=False))
    part, cpu = ProcrustesDisparity(device="cuda"), ProcrustesDisparity(device="cpu")
    for i in range(0, POSE_CPU_N, POSE_UPDATE):
        part.update(pred[i:i + POSE_UPDATE], gt[i:i + POSE_UPDATE])
        cpu.update(pred[i:i + POSE_UPDATE].cpu(), gt[i:i + POSE_UPDATE].cpu())
    want = procrustes_disparity(pred[b].cpu(), gt[b].cpu(), return_all=True)
    res["max_abs_diff_vs_cpu"] = {
        "mean_disparity": _agree("Procrustes mean", part.compute(), cpu.compute(), False, PROCRUSTES_RTOL, 0.0),
        "disparity": _agree("Procrustes disparity", d, want[0], False, PROCRUSTES_RTOL, 1e-7),
        "scale": _agree("Procrustes scale", s, want[1], False, PROCRUSTES_RTOL, 0.0),
        "rotation": _agree("Procrustes rotation", rot, want[2], False, 0.0, ROTATION_ATOL)}
    log(f"Human3.6M-sized Procrustes: {json.dumps(res)}")
    return res


def runtime_leftovers(seed: int) -> dict:
    """``to_device`` card -> CPU -> card between updates against the single stream on the card (a list-state and
    a sum-state metric); ``state_fingerprint`` of a card metric and its CPU twin; the forward-state check on the
    card; ``plot()``, which draws where matplotlib is installed and raises the JAX package's error where not."""
    import contextlib
    import io

    from metrics_tpu_torch.clustering import MutualInfoScore
    from metrics_tpu_torch.regression import MeanSquaredError
    from metrics_tpu_torch.utils import plot as tplot
    from metrics_tpu_torch.utils.checks import check_forward_full_state_property

    g = _generator(seed + 36)
    batches = [(torch.randint(0, 50, (1 << 16,), generator=g, device="cuda"),
                torch.randint(0, 40, (1 << 16,), generator=g, device="cuda")) for _ in range(4)]
    res = {"to_device_ms": []}
    moved, single, twin = MutualInfoScore(device="cuda"), MutualInfoScore(device="cuda"), MutualInfoScore(device="cpu")
    mse_moved, mse_single = MeanSquaredError(device="cuda"), MeanSquaredError(device="cuda")
    for i, (p, t) in enumerate(batches):
        moved.update(p.to(moved.device), t.to(moved.device))
        mse_moved.update(p.float().to(mse_moved.device), t.float().to(mse_moved.device))
        single.update(p, t)
        mse_single.update(p.float(), t.float())
        twin.update(p.cpu(), t.cpu())
        if i in (0, 2):
            dest = "cpu" if i == 0 else "cuda"
            _, ms = _timed(lambda: (moved.to_device(dest), mse_moved.to_device(dest)))
            res["to_device_ms"].append(ms)
    if moved.device.type != "cuda" or any(v.device.type != "cuda" for v in moved.preds + moved.target):
        fail("to_device: the metric's states did not come back to the card")
    if not torch.equal(moved.compute(), single.compute()):
        fail("to_device: the moved metric differs from the single stream")
    res["mse_abs_diff_vs_single"] = _agree("to_device MSE", mse_moved.compute(), mse_single.compute().cpu(), False,
                                           1e-6, 0.0)
    digests = {single.state_fingerprint(), twin.state_fingerprint(), moved.state_fingerprint()}
    if len(digests) != 1:
        fail("state_fingerprint: the card metric, its CPU twin and the moved metric differ")
    res["fingerprint"] = digests.pop()
    x, y = torch.rand(1 << 16, generator=g, device="cuda"), torch.rand(1 << 16, generator=g, device="cuda")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        (res["forward_check_partial_state_ok"], res["forward_check_ms"]) = _timed(
            lambda: check_forward_full_state_property(MeanSquaredError, {"device": "cuda"}, {"preds": x, "target": y},
                                                      num_update_to_compare=(10, 100), reps=2))
    res["forward_check_printed"] = printed.getvalue().strip().splitlines()
    if not res["forward_check_printed"][-1].startswith("Recommended setting `full_state_update="):
        fail(f"forward-state check: {res['forward_check_printed']}")
    if tplot._MATPLOTLIB_AVAILABLE:
        import matplotlib

        matplotlib.use("Agg")
        fig, ax = single.plot()
        if not ax.get_lines():
            fail("plot: nothing drawn")
        res["plot"] = "drawn (matplotlib installed)"
    else:
        try:
            single.plot()
        except ModuleNotFoundError as err:
            if str(err) != MATPLOTLIB_ERROR:
                fail(f"plot without matplotlib raised {err!r}")
            res["plot"] = "raised the missing-matplotlib error"
        else:
            fail("plot without matplotlib did not raise")
    log(f"runtime leftovers: {json.dumps(res)}")
    return res



def sketches_windows_drift(seed: int, wrappers: dict, out: dict, imagenet, imagenet_gpu) -> None:
    """The streaming sketches, time windows and drift detectors, then ``MetricLogbook``: a Criteo-sized
    click stream (AUROC and ECE sketches, HyperLogLog of a Zipf id column, a reservoir of the scores), DDSketch
    over 2^26 request latencies, PSI and KS of the 13 integer features, CUSUM on the per-update click rate, one
    hour of timestamped updates through the four window classes, and two epochs of the ImageNet-1k evaluation
    logged. None launches a kernel; each is checked against the port's CPU run of a stated subset and against
    its four shards merged on the card, and the sketch and drift updates must read nothing back from the card."""

    def counting(name, body):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = section(name, body)
        torch.cuda.synchronize()
        result.update({"launches": {k: w.launches for k, w in wrappers.items()}, "expected_launches": {}})
        out[name] = result

    t0 = time.perf_counter()
    counting("Criteo click stream[AUROC, ECE, HLL, reservoir], CUSUM", lambda: criteo_stream(seed))
    counting("request latencies[DDSketch]", lambda: latency_quantiles(seed))
    counting("Criteo feature drift[13 x (PSI, KS)]", lambda: criteo_drift(seed))
    counting("one hour of time windows", lambda: time_windows(seed))
    counting("MetricLogbook over two ImageNet-1k epochs", lambda: logbook_imagenet(imagenet, imagenet_gpu))
    SECTION_S["sketches_windows_drift"] = time.perf_counter() - t0


class _UpdateLog:
    """Each class's update times, host synchronizations (CUDA's sync debug mode) and peak memory."""

    def __init__(self):
        self.ms, self.syncs, self.peak_mb = {}, {}, {}

    def run(self, name, fn):
        import warnings

        # the peak is read on the first updates and every 64th (reading the allocator's statistics costs more
        # than a small update); every update is timed and watched for synchronizations
        count = len(self.ms.get(name, ()))
        peak = count < 3 or count % 64 == 0
        if peak:
            base = _reset_peak()
        else:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        self.ms.setdefault(name, []).append(1000 * (time.perf_counter() - t0))
        self.syncs.setdefault(name, []).append(
            sum("called a synchronizing CUDA operation" in str(w.message) for w in caught))
        if peak:
            self.peak_mb[name] = max(self.peak_mb.get(name, 0.0), _peak_mb(base))

    def summary(self, name, compute_ms=None):
        ms, syncs = self.ms[name], self.syncs[name]
        return {"updates": len(ms), "first_update_ms": ms[0], "later_update_ms_median": _median_ms(ms),
                "compute_ms": compute_ms, "update_peak_mb": self.peak_mb[name],
                "host_syncs_per_later_update_max": max(syncs[1:]) if len(syncs) > 1 else None}


NO_SYNC_CLASSES = ("HyperLogLog", "DDSketch", "ReservoirSample", "StreamingAUROC", "StreamingCalibrationError", "PSI",
                   "KSDistance", "CUSUM")


def _check_no_sync(log_: _UpdateLog, name: str, cls: str) -> None:
    if cls in NO_SYNC_CLASSES and any(log_.syncs[name][1:]):
        fail(f"{name}: a later {cls} update synchronized with the host {max(log_.syncs[name][1:])} times")


def _states_agree(name, got: dict, want: dict, rtol: float, atol: float = 0.0) -> dict:
    """Integer states equal and float states bit-equal where ``rtol`` is 0, else within ``rtol``/``atol``;
    returns the largest absolute difference of each."""
    res = {}
    for key in want:
        g, w = got[key].detach().cpu(), want[key].detach().cpu()
        exact = rtol == 0.0 or not w.is_floating_point()
        res[key] = _agree(f"{name}[{key}]", g, w, exact, rtol, atol)
        if exact and w.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[w.element_size()]
            if not torch.equal(g.view(bits), w.view(bits)):
                fail(f"{name}[{key}]: the bits differ")
    return res


def _merged(shards):
    """The shards folded in stream order with ``merge_state`` (an incoming state counts as the earlier one)."""
    acc = shards[-1]
    for shard in reversed(shards[:-1]):
        acc.merge_state(shard)
    return acc


def criteo_batch(g: torch.Generator, n: int, shift: float):
    """(score, click, id): a CTR model's scores and clicks drawn from a latent logit, and a Zipf-distributed id."""
    z = CRITEO_LOGIT_MU + shift + CRITEO_LOGIT_SD * torch.randn(n, generator=g, device="cuda")
    click = (torch.rand(n, generator=g, device="cuda") < torch.sigmoid(z)).to(torch.int32)
    score = torch.sigmoid(z + CRITEO_SCORE_NOISE * torch.randn(n, generator=g, device="cuda"))
    u = torch.rand(n, generator=g, device="cuda", dtype=torch.float64)
    ids = torch.floor(torch.exp(u * math.log(CRITEO_ZIPF_RANKS + 1.0))).to(torch.int64)
    return score, click, ids


def _exact_ece(score: torch.Tensor, click: torch.Tensor, num_bins: int) -> float:
    """The top-label ECE over the same bins in float64, from every score."""
    from metrics_tpu_torch.functional.sketches.ecdf import _bin_index

    conf = torch.maximum(score, 1.0 - score)
    hit = ((score >= 0.5).to(torch.int32) == click).to(torch.float64)
    idx = _bin_index(conf, num_bins)
    cnt = torch.zeros(num_bins, dtype=torch.float64, device=score.device).index_add_(0, idx, torch.ones_like(hit))
    acc = torch.zeros_like(cnt).index_add_(0, idx, hit)
    cs = torch.zeros_like(cnt).index_add_(0, idx, conf.to(torch.float64))
    safe = cnt.clamp(min=1.0)
    return float((cnt * (acc / safe - cs / safe).abs()).sum() / cnt.sum())


def criteo_stream(seed: int) -> dict:
    """StreamingAUROC, StreamingCalibrationError, HyperLogLog (p = 14) and ReservoirSample (k = 10,000) over the
    45,840,617 Criteo rows in updates of 2^20, each also in four shards merged on the card; the first update
    against the CPU run; then CUSUM over the per-update click rates."""
    from metrics_tpu_torch.drift import CUSUM
    from metrics_tpu_torch.functional.classification import binary_auroc
    from metrics_tpu_torch.functional.sketches.hashing import hash32
    from metrics_tpu_torch.sketches import HyperLogLog, ReservoirSample, StreamingAUROC, StreamingCalibrationError

    makers = {
        "StreamingAUROC": (lambda d: StreamingAUROC(num_bins=CRITEO_AUROC_BINS, device=d), lambda m, b: m.update(b[0], b[1])),
        "StreamingCalibrationError": (lambda d: StreamingCalibrationError(num_bins=CRITEO_ECE_BINS, device=d),
                                      lambda m, b: m.update(b[0], b[1])),
        "HyperLogLog": (lambda d: HyperLogLog(p=CRITEO_HLL_P, device=d), lambda m, b: m.update(b[2])),
        "ReservoirSample": (lambda d: ReservoirSample(k=CRITEO_RESERVOIR, seed=seed, device=d),
                            lambda m, b: m.update(b[0])),
    }
    single = {k: make("cuda") for k, (make, _) in makers.items()}
    shards = {k: [make("cuda") for _ in range(SKETCH_SHARDS)] for k, (make, _) in makers.items()}
    subset = StreamingAUROC(num_bins=CRITEO_AUROC_BINS, device="cuda")
    g = _generator(seed + 40)
    ulog, res = _UpdateLog(), {"rows": CRITEO_ROWS}
    scores, clicks, ids, ctrs = [], [], [], []
    steps = -(-CRITEO_ROWS // CRITEO_UPDATE)
    for i in range(steps):
        n = min(CRITEO_UPDATE, CRITEO_ROWS - i * CRITEO_UPDATE)
        b = criteo_batch(g, n, CRITEO_SHIFT if i >= CRITEO_SHIFT_AT else 0.0)
        scores.append(b[0])
        clicks.append(b[1])
        ids.append(b[2])
        ctrs.append(b[1].to(torch.float32).mean().reshape(1))
        for name, (_, feed) in makers.items():
            ulog.run(name, lambda: feed(single[name], b))
            feed(shards[name][i % SKETCH_SHARDS], b)
        if i == 0:  # the CPU check: the first 2^20 rows
            b_cpu = tuple(x.cpu() for x in b)
            res["max_abs_diff_vs_cpu_first_update"] = {}
            for name, (make, feed) in makers.items():
                cpu = make("cpu")
                feed(cpu, b_cpu)
                rtol = SKETCH_RTOL if name == "StreamingCalibrationError" else 0.0
                res["max_abs_diff_vs_cpu_first_update"][name] = _states_agree(
                    f"Criteo {name} first update", single[name].metric_state, cpu.metric_state, rtol)
        if i * CRITEO_UPDATE < CRITEO_EXACT_ROWS:
            subset.update(b[0], b[1])
    for name in makers:
        _check_no_sync(ulog, name, name)
    computed = {}
    for name in makers:
        computed[name], ms = _timed(single[name].compute)
        res[name] = ulog.summary(name, ms)
    res["merged_4_shards_max_abs_diff"] = {
        name: _states_agree(f"Criteo {name} merged", _merged(shards[name]).metric_state, single[name].metric_state,
                            MERGE_RTOL if name == "StreamingCalibrationError" else 0.0) for name in makers}
    # the sketches against the exact answers
    score, click, allids = torch.cat(scores), torch.cat(clicks), torch.cat(ids)
    k = CRITEO_EXACT_ROWS
    exact_auroc = float(binary_auroc(score[:k], click[:k]))
    sub_auroc, sub_bound = float(subset.compute()), float(subset.error_bound())
    res["auroc"] = {"stream": float(computed["StreamingAUROC"]), "stream_bound": float(single["StreamingAUROC"].error_bound()),
                    "subset_rows": k, "subset_binned": sub_auroc, "subset_exact": exact_auroc,
                    "binned_auroc_bound": sub_bound}
    if not abs(sub_auroc - exact_auroc) <= sub_bound + 1e-6:
        fail(f"StreamingAUROC {sub_auroc} is {abs(sub_auroc - exact_auroc)} from the exact {exact_auroc}, "
             f"beyond its bound {sub_bound}")
    exact_ece = _exact_ece(score, click, CRITEO_ECE_BINS)
    res["ece"] = {"stream": float(computed["StreamingCalibrationError"]), "exact_float64": exact_ece}
    if not abs(float(computed["StreamingCalibrationError"]) - exact_ece) <= 1e-5:
        fail(f"StreamingCalibrationError {float(computed['StreamingCalibrationError'])} against {exact_ece}")
    distinct = int(torch.unique(allids).numel())
    est = float(computed["HyperLogLog"])
    res["hll"] = {"estimate": est, "exact_distinct": distinct, "rel_err": abs(est - distinct) / distinct,
                  "std_error": single["HyperLogLog"].std_error}
    if not res["hll"]["rel_err"] <= 5 * single["HyperLogLog"].std_error:
        fail(f"HyperLogLog {est} against {distinct} distinct ids, beyond 5 standard errors")
    h = hash32(score, seed)
    key = (h >> 16) * 65536 + (h & 0xFFFF)
    by_value = torch.sort(score, stable=True).indices
    oracle = torch.sort(score[by_value[torch.sort(key[by_value], stable=True).indices[:CRITEO_RESERVOIR]]]).values
    kept = torch.sort(computed["ReservoirSample"]).values
    if not torch.equal(kept, oracle):
        fail("ReservoirSample: the sample is not the bottom k of the whole stream")
    res["reservoir"] = {"k": CRITEO_RESERVOIR, "equals_exact_bottom_k": True}
    # CUSUM over the per-update click-rate stream: the target is the first ten updates' mean rate
    rates = torch.cat(ctrs)
    target = float(rates[:10].mean())
    cusum, cusum_cpu = CUSUM(target, CUSUM_K, CUSUM_H, device="cuda"), CUSUM(target, CUSUM_K, CUSUM_H, device="cpu")
    parts = [CUSUM(target, CUSUM_K, CUSUM_H, device="cuda") for _ in range(SKETCH_SHARDS)]
    bounds = np.linspace(0, steps, SKETCH_SHARDS + 1).astype(int)
    alarm_before = None
    for i in range(steps):
        ulog.run("CUSUM", lambda: cusum.update(rates[i:i + 1]))
        cusum_cpu.update(rates[i:i + 1].cpu())
        parts[int(np.searchsorted(bounds, i, side="right")) - 1].update(rates[i:i + 1])
        if i == CRITEO_SHIFT_AT - 1:
            alarm_before = float(cusum.compute()[2])
    _check_no_sync(ulog, "CUSUM", "CUSUM")
    final, ms = _timed(cusum.compute)
    res["CUSUM"] = ulog.summary("CUSUM", ms)
    res["CUSUM"].update({"target_rate": target, "alarm_before_shift": alarm_before, "final": final.tolist(),
                         "max_abs_diff_vs_cpu": _agree("CUSUM", final, cusum_cpu.compute(), False, 1e-5, 1e-6),
                         "merged_4_segments_max_abs_diff": _states_agree(
                             "CUSUM merged", _merged(parts).metric_state, cusum.metric_state, 1e-5, 1e-6)})
    if alarm_before != 0.0 or float(final[2]) != 1.0:
        fail(f"CUSUM: alarm {alarm_before} before the shift at update {CRITEO_SHIFT_AT}, {float(final[2])} at the end")
    log(f"Criteo click stream: {json.dumps(res)}")
    return res


def latency_quantiles(seed: int) -> dict:
    """DDSketch (alpha 0.01) over 2^26 log-normal latencies with 1 % zeros and 0.1 % non-finite values, in
    updates of 2^20 and in four shards merged; the first update against the CPU run; each quantile within alpha
    of the exact one."""
    from metrics_tpu_torch.sketches import DDSketch

    def make(d):
        return DDSketch(alpha=LATENCY_ALPHA, quantiles=LATENCY_QUANTILES, device=d)

    g = _generator(seed + 41)
    single, shards, ulog, res, kept = make("cuda"), [make("cuda") for _ in range(SKETCH_SHARDS)], _UpdateLog(), {}, []
    for i in range(LATENCY_N // CRITEO_UPDATE):
        v = torch.exp(math.log(50.0) + 0.8 * torch.randn(CRITEO_UPDATE, generator=g, device="cuda"))
        u = torch.rand(CRITEO_UPDATE, generator=g, device="cuda")
        v = torch.where(u < LATENCY_ZEROS, 0.0, v)
        v = torch.where(u > 1.0 - LATENCY_NONFINITE, torch.where(u > 1.0 - LATENCY_NONFINITE / 2, torch.inf, torch.nan), v)
        kept.append(v)
        ulog.run("DDSketch", lambda: single.update(v))
        shards[i % SKETCH_SHARDS].update(v)
        if i == 0:
            cpu = make("cpu")
            cpu.update(v.cpu())
            res["state_diff_vs_cpu_first_update"] = _states_agree("DDSketch first update", single.metric_state,
                                                                   cpu.metric_state, 0.0)
    _check_no_sync(ulog, "DDSketch", "DDSketch")
    est, ms = _timed(single.compute)
    res.update(ulog.summary("DDSketch", ms))
    res["merged_4_shards"] = _states_agree("DDSketch merged", _merged(shards).metric_state, single.metric_state, 0.0)
    allv = torch.cat(kept)
    finite = torch.sort(allv[torch.isfinite(allv)]).values
    rank = torch.tensor(LATENCY_QUANTILES, dtype=torch.float64, device="cuda") * (finite.numel() - 1)
    lo = rank.floor().long()
    frac = (rank - lo).to(torch.float32)
    exact = finite[lo] + frac * (finite[(lo + 1).clamp(max=finite.numel() - 1)] - finite[lo])
    rel = ((est - exact).abs() / exact).tolist()
    res.update({"values": LATENCY_N, "quantiles": list(LATENCY_QUANTILES), "estimate_ms": est.tolist(),
                "exact_ms": exact.tolist(), "rel_err": rel})
    if not all(r <= LATENCY_ALPHA + 1e-6 for r in rel):
        fail(f"DDSketch: relative errors {rel} beyond alpha {LATENCY_ALPHA}")
    log(f"request latencies: {json.dumps(res)}")
    return res


def criteo_drift(seed: int) -> dict:
    """PSI and KS distance of each of Criteo's 13 integer features (a log-normal count per feature), one day of
    reference against one live day whose mean is shifted by 0.6 sigma on three features, in updates of 2^20;
    each feature's pair is one collection (a collection feeds every member the same inputs; the pair shares one
    compute group). The first update against the CPU run, four shards merged, and standalone PSI and KS updates
    for the host-sync count."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.drift import KSDistance, PSI

    mu = [0.5 + 0.2 * f for f in range(CRITEO_INT_FEATURES)]
    sd = [0.8 + 0.07 * f for f in range(CRITEO_INT_FEATURES)]
    hi = [float(math.ceil(math.exp(m + 3.0 * s))) for m, s in zip(mu, sd)]

    def make(f, d):
        return MetricCollection({"psi": PSI(lo=0.0, hi=hi[f], num_bins=DRIFT_BINS, device=d),
                                 "ks": KSDistance(lo=0.0, hi=hi[f], num_bins=DRIFT_BINS, device=d)})

    def column(g, n, f, live):
        shift = DRIFT_SHIFT_SD * sd[f] if live and f in DRIFT_SHIFTED else 0.0
        return torch.floor(torch.exp(mu[f] + shift + sd[f] * torch.randn(n, generator=g, device="cuda")))

    g = _generator(seed + 42)
    single = [make(f, "cuda") for f in range(CRITEO_INT_FEATURES)]
    shards = [[make(f, "cuda") for f in range(CRITEO_INT_FEATURES)] for _ in range(SKETCH_SHARDS)]
    probes = {"PSI": PSI(lo=0.0, hi=hi[0], num_bins=DRIFT_BINS, device="cuda"),
              "KSDistance": KSDistance(lo=0.0, hi=hi[0], num_bins=DRIFT_BINS, device="cuda")}
    ulog, res = _UpdateLog(), {"features": CRITEO_INT_FEATURES, "day_rows": DRIFT_DAY_ROWS}
    steps = -(-DRIFT_DAY_ROWS // CRITEO_UPDATE)
    for i in range(steps):
        n = min(CRITEO_UPDATE, DRIFT_DAY_ROWS - i * CRITEO_UPDATE)
        for f in range(CRITEO_INT_FEATURES):
            live, ref = column(g, n, f, True), column(g, n, f, False)
            if f == 0:
                ulog.run("13 collections", lambda: single[f].update(live, ref))
            else:
                single[f].update(live, ref)
            shards[i % SKETCH_SHARDS][f].update(live, ref)
            if f == 0:
                for name, m in probes.items():
                    ulog.run(name, lambda: m.update(live, ref))
            if i == 0:
                cpu = make(f, "cpu")
                cpu.update(live.cpu(), ref.cpu())
                for key in ("psi", "ks"):
                    _states_agree(f"drift I{f + 1} {key} first update", single[f][key].metric_state,
                                  cpu[key].metric_state, 0.0)
    for name in probes:
        _check_no_sync(ulog, name, name)
    values, ms = _timed(lambda: [c.compute() for c in single])
    res["compute_13_collections_ms"] = ms
    for name in probes:
        res[name] = ulog.summary(name)
    res["feature_I1_collection_update"] = ulog.summary("13 collections")
    for f in range(CRITEO_INT_FEATURES):
        for key in ("psi", "ks"):
            merged = _merged([shards[s][f][key] for s in range(SKETCH_SHARDS)])
            _states_agree(f"drift I{f + 1} {key} merged", merged.metric_state, single[f][key].metric_state, 0.0)
    res["psi"] = [float(v["psi"]) for v in values]
    res["ks"] = [float(v["ks"]) for v in values]
    res["first_update_and_merge"] = "states equal on every feature"
    for f in range(CRITEO_INT_FEATURES):
        shifted = f in DRIFT_SHIFTED
        if shifted != (res["psi"][f] > 0.25) or (not shifted and res["psi"][f] >= 0.1):
            fail(f"PSI of feature I{f + 1}: {res['psi'][f]} (shifted: {shifted})")
        if shifted != (res["ks"][f] > 0.1):
            fail(f"KS of feature I{f + 1}: {res['ks'][f]} (shifted: {shifted})")
    log(f"Criteo feature drift: {json.dumps(res)}")
    return res


def time_windows(seed: int) -> dict:
    """One hour of a service's events, one update a second of 4,096 (1 % of the updates late by up to two panes),
    through TimeDecayed over a mean (plain and compensated), TumblingWindow over a sum, DecayedDDSketch and
    DecayedHLL; each against the port's CPU run of the first 300 updates, against float64 oracles of the whole
    hour, and with four shards (every fourth second) merged on the card."""
    from metrics_tpu_torch import MeanMetric, SumMetric
    from metrics_tpu_torch.windows import DecayedDDSketch, DecayedHLL, TimeDecayed, TumblingWindow

    makers = {
        "TimeDecayed[MeanMetric]": lambda d: TimeDecayed(MeanMetric(nan_strategy="disable", device=d),
                                                         half_life_s=WINDOW_HALF_LIFE),
        "TimeDecayed[MeanMetric, compensated]": lambda d: TimeDecayed(
            MeanMetric(nan_strategy="disable", device=d), half_life_s=WINDOW_HALF_LIFE, compensated=True),
        "TumblingWindow[SumMetric]": lambda d: TumblingWindow(SumMetric(nan_strategy="disable", device=d),
                                                              pane_s=WINDOW_PANE_S, n_panes=WINDOW_PANES),
        "DecayedDDSketch": lambda d: DecayedDDSketch(half_life_s=WINDOW_HALF_LIFE, device=d),
        "DecayedHLL": lambda d: DecayedHLL(half_life_s=WINDOW_HALF_LIFE, device=d),
    }
    inputs = {"DecayedHLL": 1}  # the index of each class's input in (latency, user id); the rest take latencies
    rng = np.random.default_rng(seed + 43)
    late = rng.random(WINDOW_SECONDS) < WINDOW_LATE
    stamps = np.arange(WINDOW_SECONDS, dtype=np.float64) + 0.5
    stamps[late] -= rng.uniform(1.0, 2 * WINDOW_PANE_S, late.sum())
    stamps = np.maximum(stamps, 0.0).astype(np.float32).tolist()
    g = _generator(seed + 43)
    single = {k: make("cuda") for k, make in makers.items()}
    shards = {k: [make("cuda") for _ in range(SKETCH_SHARDS)] for k, make in makers.items()}
    cpu = {k: make("cpu") for k, make in makers.items()}
    ulog, res, sums = _UpdateLog(), {"updates": WINDOW_SECONDS, "late_updates": int(late.sum())}, []
    snapshot = {}
    for i, t in enumerate(stamps):
        lat = torch.exp(math.log(50.0) + 0.8 * torch.randn(WINDOW_EVENTS, generator=g, device="cuda"))
        users = torch.randint(0, 1 << 20, (WINDOW_EVENTS,), generator=g, device="cuda")
        batch = (lat, users)
        sums.append(lat.double().sum().reshape(1))
        for name, m in single.items():
            x = batch[inputs.get(name, 0)]
            ulog.run(name, lambda: m.update(t, x))
            shards[name][i % SKETCH_SHARDS].update(t, x)
            if i < WINDOW_CPU_UPDATES:
                cpu[name].update(t, x.cpu())
        if i == WINDOW_CPU_UPDATES - 1:
            snapshot = {k: {s: v.clone() for s, v in m.metric_state.items()} for k, m in single.items()}
    res["state_max_abs_diff_vs_cpu_first_300"] = {
        k: _states_agree(f"{k} first {WINDOW_CPU_UPDATES} updates", _folded(snapshot[k]), _folded(cpu[k].metric_state),
                         0.0 if k.startswith("Decayed") else SKETCH_RTOL) for k in makers}
    for name in makers:
        value, ms = _timed(single[name].compute)
        res[name] = ulog.summary(name, ms)
        res[name]["value"] = value.tolist()
        res[name]["merged_4_shards_max_abs_diff"] = _agree(
            f"{name} merged", _merged(shards[name]).compute(), value.cpu(), False, MERGE_RTOL, 0.0)
    # float64 oracles of the hour: the decayed mean, and the window's sum over the last 60 panes
    t64 = torch.tensor(stamps, dtype=torch.float64)
    s64 = torch.cat(sums).cpu()
    ref = float(t64.max())
    w = torch.exp2(-(ref - t64) / WINDOW_HALF_LIFE)
    oracle_mean = float((w * s64).sum() / (w * WINDOW_EVENTS).sum())
    panes = torch.floor(t64 / WINDOW_PANE_S)
    in_window = panes > panes.max() - WINDOW_PANES
    oracle_sum = float(s64[in_window].sum())
    res["oracles"] = {"decayed_mean": oracle_mean, "window_sum": oracle_sum}
    for name, want in (("TimeDecayed[MeanMetric]", oracle_mean), ("TimeDecayed[MeanMetric, compensated]", oracle_mean),
                       ("TumblingWindow[SumMetric]", oracle_sum)):
        if not abs(res[name]["value"] - want) <= 1e-4 * abs(want):
            fail(f"{name}: {res[name]['value']} against the float64 oracle {want}")
    log(f"time windows: {json.dumps(res)}")
    return res


def _folded(state: dict) -> dict:
    """A state dict with each compensated pair read out (``<name> + <name>_comp``): the residual alone is rounding
    noise, whose card and CPU values need not be close."""
    return {k: v + state[f"{k}_comp"] if f"{k}_comp" in state else v for k, v in state.items()
            if not k.endswith("_comp")}


def logbook_imagenet(imagenet, imagenet_gpu) -> dict:
    """Two epochs of the ImageNet-1k evaluation through ``MetricLogbook``: a ``MeanMetric`` of the per-sample
    cross-entropy logged per batch (``forward``) and an accuracy collection updated, against the same on the
    CPU; both epochs must read the same values."""
    from metrics_tpu_torch import MeanMetric, MetricCollection
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.integration import MetricLogbook

    def epochs(device, batches):
        book = MetricLogbook()
        step_losses, ms = [], []
        for _ in range(2):
            for logits, target in batches:
                loss = F.cross_entropy(logits, target, reduction="none")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step_losses.append(book.log_batch("loss", lambda: MeanMetric(device=device), loss))
                book.update("val", lambda: MetricCollection({
                    "top1": tc.MulticlassAccuracy(num_classes=IN_CLASSES, average="micro", device=device),
                    "macro": tc.MulticlassAccuracy(num_classes=IN_CLASSES, average="macro", device=device)}),
                    logits, target)
                torch.cuda.synchronize()
                ms.append(1000 * (time.perf_counter() - t0))
            book.epoch_end()
        return book, ms

    book, ms = epochs("cuda", imagenet_gpu)
    book_cpu, _ = epochs("cpu", imagenet)
    res = {"epochs": len(book.history), "step_ms_median": _median_ms(ms), "values": {}}
    if len(book.history) != 2 or book["loss"].update_count != 0:
        fail("MetricLogbook: two epochs recorded and the metrics reset")
    for key in ("loss", "val_top1", "val_macro"):
        first, second, want = book.history[0][key], book.history[1][key], book_cpu.history[0][key]
        if not torch.equal(first, second):
            fail(f"MetricLogbook {key}: the two epochs differ")
        res["values"][key] = float(first)
        _agree(f"MetricLogbook {key}", first, want, False, STAT_RTOL, STAT_ATOL)
    log(f"MetricLogbook: {json.dumps(res)}")
    return res



# ----------------------------------------------------------------------------- phase 4, text and audio
AUDIO_NO_SYNC = ("SignalNoiseRatio", "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio",
                 "SourceAggregatedSignalDistortionRatio", "PermutationInvariantTraining", "SignalDistortionRatio",
                 "ComplexScaleInvariantSignalNoiseRatio", "MetricCollection[Libri2Mix]")


def text_and_audio(seed: int, wrappers: dict, out: dict) -> None:
    """Text and audio without models, all data synthetic from ``seed``: error rates at LibriSpeech test-clean
    size, BLEU, SacreBLEU, chrF, chrF++, EED and TER at WMT14 en-de size, ROUGE at CNN/DailyMail size, SQuAD at
    its dev size, perplexity over WikiText-103 test in GPT-2 tokens, the signal-level metrics over Libri2Mix and
    PIT over Libri3Mix, STOI and ESTOI, SRMR, and the gated metrics. None launches a kernel. Each is checked
    against the port's CPU run of a stated subset; the WER, BLEU and SI-SDR streams also in four shards merged
    on the card; a later audio update that synchronizes with the host fails the run (PIT over three sources
    reads its matrix once an update, by design)."""

    def counting(name, body):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = section(name, body)
        torch.cuda.synchronize()
        result.update({"launches": {k: w.launches for k, w in wrappers.items()}, "expected_launches": {}})
        out[name] = result

    t0 = time.perf_counter()
    vocab = _vocabulary(np.random.default_rng(seed + 60), LIBRI_VOCAB)
    counting("LibriSpeech test-clean[WER, MER, WIL, WIP, CER, EditDistance]", lambda: librispeech_error_rates(seed, vocab))
    counting("WMT14 en-de[BLEU, SacreBLEU 13a, chrF, chrF++, EED, TER]", lambda: wmt_translation(seed, vocab))
    counting("CNN/DailyMail[ROUGE-1/2/L/Lsum]", lambda: cnndm_rouge(seed, vocab))
    counting("SQuAD v1.1 dev[EM, F1]", lambda: squad_dev(seed, vocab))
    counting("WikiText-103 test[Perplexity]", lambda: wikitext_perplexity(seed))
    counting("Libri2Mix test[SNR, SI-SDR, SI-SNR, SA-SDR, PIT, SDR, C-SI-SNR]", lambda: libri2mix(seed))
    counting("Libri3Mix[PIT, 3 sources]", lambda: libri3mix(seed))
    counting("STOI and ESTOI", lambda: stoi_speech(seed))
    counting("SRMR", lambda: srmr_speech(seed))
    counting("gated audio metrics[PESQ, DNSMOS, NISQA]", gated_audio)
    SECTION_S["text_and_audio"] = time.perf_counter() - t0


def _vocabulary(rng: np.random.Generator, n: int):
    """``n`` distinct lowercase words of 2-8 letters and the cumulative Zipf probabilities (exponent 1)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    seen, words = set(), []
    while len(words) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        if w not in seen:
            seen.add(w)
            words.append(w)
    p = np.cumsum(1.0 / np.arange(1, n + 1))
    return words, p / p[-1]


def _draw(rng, vocab, k):
    words, cdf = vocab
    return [words[i] for i in np.minimum(np.searchsorted(cdf, rng.random(k)), len(words) - 1)]


def _corrupt_tokens(rng, tokens, vocab, sub, ins, dele):
    """``tokens`` with each token deleted with probability ``dele``, else replaced with probability ``sub``, and
    a random word inserted after it with probability ``ins``."""
    words = vocab[0]
    out = []
    for tok, r, q in zip(tokens, rng.random(len(tokens)), rng.random(len(tokens))):
        if r < dele:
            continue
        out.append(words[int(rng.integers(len(words)))] if r < dele + sub else tok)
        if q < ins:
            out.append(words[int(rng.integers(len(words)))])
    return out


def _text_metric_run(name, make, batches, ulog, res, cpu_check=True):
    """``make("cuda")`` fed every batch (timed, syncs counted), its states after the first batch against
    ``make("cpu")``'s (equal); returns the metric."""
    metric = make("cuda")
    for i, batch in enumerate(batches):
        ulog.run(name, lambda: metric.update(*batch))
        if i == 0 and cpu_check:
            cpu = make("cpu")
            cpu.update(*batch)
            res.setdefault("max_abs_diff_vs_cpu_first_update", {})[name] = _states_agree(
                f"{name} first update", metric.metric_state, cpu.metric_state, 0.0)
    return metric


def librispeech_error_rates(seed: int, vocab) -> dict:
    """WER, MER, WIL and WIP over the 2,620 utterances in updates of 131, the WER stream also in four shards;
    CER and EditDistance over the first 500 (the character DP is host Python); the first update against the CPU
    run."""
    from metrics_tpu_torch.text import (
        CharErrorRate, EditDistance, MatchErrorRate, WordErrorRate, WordInfoLost, WordInfoPreserved,
    )

    rng = np.random.default_rng(seed + 61)
    preds, target = [], []
    for k in rng.poisson(LIBRI_WORDS - 1, LIBRI_UTTS) + 1:
        ref = _draw(rng, vocab, int(k))
        target.append(" ".join(ref))
        preds.append(" ".join(_corrupt_tokens(rng, ref, vocab, LIBRI_SUB, LIBRI_INS, LIBRI_DEL)))
    batches = [(preds[i:i + LIBRI_UPDATE], target[i:i + LIBRI_UPDATE]) for i in range(0, LIBRI_UTTS, LIBRI_UPDATE)]
    ulog = _UpdateLog()
    res = {"utterances": LIBRI_UTTS, "words": sum(len(t.split()) for t in target),
           "characters": sum(len(t) for t in target)}
    metrics = {name: _text_metric_run(name, lambda d, c=cls: c(device=d), batches, ulog, res)
               for name, cls in (("WordErrorRate", WordErrorRate), ("MatchErrorRate", MatchErrorRate),
                                 ("WordInfoLost", WordInfoLost), ("WordInfoPreserved", WordInfoPreserved))}
    shards = [WordErrorRate(device="cuda") for _ in range(TEXT_SHARDS)]
    for i, batch in enumerate(batches):
        shards[i % TEXT_SHARDS].update(*batch)
    cer_batches = [(preds[i:i + 100], target[i:i + 100]) for i in range(0, LIBRI_CER_UTTS, 100)]
    metrics["CharErrorRate"] = _text_metric_run("CharErrorRate", lambda d: CharErrorRate(device=d), cer_batches,
                                                ulog, res)
    metrics["EditDistance"] = _text_metric_run("EditDistance", lambda d: EditDistance(device=d), cer_batches,
                                               ulog, res)
    for name, metric in metrics.items():
        value, ms = _timed(metric.compute)
        res[name] = ulog.summary(name, ms)
        n = LIBRI_CER_UTTS if name in ("CharErrorRate", "EditDistance") else LIBRI_UTTS
        res[name].update({"value": float(value), "update_ms_per_utterance": float(sum(ulog.ms[name])) / n})
    res["WordErrorRate_merged_4_shards"] = _states_agree("WER merged", _merged(shards).metric_state,
                                                         metrics["WordErrorRate"].metric_state, 0.0)
    wer, wil, wip = (res[k]["value"] for k in ("WordErrorRate", "WordInfoLost", "WordInfoPreserved"))
    expected = LIBRI_SUB + LIBRI_INS + LIBRI_DEL
    if not abs(wer - expected) < 0.02:
        fail(f"LibriSpeech WER {wer} against the {expected} the hypotheses were drawn with")
    if float(np.float32(1.0) - np.float32(wip)) != wil:
        fail(f"LibriSpeech WIL {wil} is not 1 - WIP ({wip})")
    log(f"LibriSpeech test-clean error rates: {json.dumps(res)}")
    return res


def _wmt_segments(rng, vocab, n):
    """(hypotheses, references): about 22 tokens each, some with punctuation attached, a capital, a number, a
    final full stop; hypotheses with 20 % substitutions, 3 % insertions and deletions, and in 30 % of them two
    spans of three tokens swapped."""
    punct = [",", ";", ":", "?", "!", "'s", "%", ")"]
    hyps, refs = [], []
    for k in rng.poisson(WMT_TOKENS - 3, n) + 2:
        toks = _draw(rng, vocab, int(k))
        for j in np.flatnonzero(rng.random(len(toks)) < 0.12):
            toks[j] = toks[j] + str(rng.choice(punct))
        toks[0] = toks[0].capitalize()
        if rng.random() < 0.2:
            toks.insert(int(rng.integers(0, len(toks))), str(int(rng.integers(1, 2030))))
        ref = toks + ["."]
        hyp = _corrupt_tokens(rng, ref, vocab, 0.2, 0.03, 0.03)
        if rng.random() < 0.3 and len(hyp) > 6:
            a = int(rng.integers(0, len(hyp) - 6))
            hyp = hyp[:a] + hyp[a + 3:a + 6] + hyp[a:a + 3] + hyp[a + 6:]
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    return hyps, refs


def wmt_translation(seed: int, vocab) -> dict:
    """BLEU, SacreBLEU (13a), chrF and chrF++ over the 3,003 segments in updates of 273, the BLEU stream also in
    four shards; EED over the first 200 pairs and TER over 8 pairs cut to 15 tokens; the first update (and 20
    EED, 2 TER pairs) against the CPU run; BLEU's device compute against the CPU's on the same counts."""
    from metrics_tpu_torch.text import BLEUScore, CHRFScore, ExtendedEditDistance, SacreBLEUScore, TranslationEditRate

    rng = np.random.default_rng(seed + 62)
    hyps, refs = _wmt_segments(rng, vocab, WMT_SEGS)
    targets = [[r] for r in refs]
    batches = [(hyps[i:i + WMT_UPDATE], targets[i:i + WMT_UPDATE]) for i in range(0, WMT_SEGS, WMT_UPDATE)]
    ulog, res = _UpdateLog(), {"segments": WMT_SEGS, "reference_tokens": sum(len(r.split()) for r in refs)}
    makers = {"BLEUScore": lambda d: BLEUScore(device=d), "SacreBLEUScore[13a]": lambda d: SacreBLEUScore(device=d),
              "CHRFScore[chrF]": lambda d: CHRFScore(n_word_order=0, device=d),
              "CHRFScore[chrF++]": lambda d: CHRFScore(device=d)}
    metrics = {name: _text_metric_run(name, make, batches, ulog, res) for name, make in makers.items()}
    shards = [BLEUScore(device="cuda") for _ in range(TEXT_SHARDS)]
    for i, batch in enumerate(batches):
        shards[i % TEXT_SHARDS].update(*batch)
    for name, metric in metrics.items():
        value, ms = _timed(metric.compute)
        cpu = makers[name]("cpu")
        cpu.load_merged_state({k: v.cpu() for k, v in metric.metric_state.items()}, metric.update_count)
        res[name] = ulog.summary(name, ms)
        res[name].update({"value": float(value), "abs_diff_vs_cpu_compute": _agree(
            f"{name} compute", value.cpu(), cpu.compute(), False, 1e-6, 0.0)})
        if not 0.0 < float(value) < 1.0:
            fail(f"WMT {name} {float(value)} outside (0, 1)")
    res["BLEUScore_merged_4_shards"] = _states_agree("BLEU merged", _merged(shards).metric_state,
                                                     metrics["BLEUScore"].metric_state, 0.0)
    for name, make, n, n_cpu, cut in (
            ("ExtendedEditDistance", lambda d: ExtendedEditDistance(device=d), WMT_EED_PAIRS, 20, None),
            ("TranslationEditRate", lambda d: TranslationEditRate(device=d), WMT_TER_PAIRS, 2, WMT_TER_TOKENS)):
        h = [" ".join(x.split()[:cut]) for x in hyps[:n]] if cut else hyps[:n]
        r = [[" ".join(x.split()[:cut])] for x in refs[:n]] if cut else targets[:n]
        metric = make("cuda")
        metric.update(h, r)
        value, ms = _timed(metric.compute)
        sub_gpu, sub_cpu = make("cuda"), make("cpu")
        sub_gpu.update(h[:n_cpu], r[:n_cpu])
        sub_cpu.update(h[:n_cpu], r[:n_cpu])
        got, want = sub_gpu.compute(), sub_cpu.compute()
        if got.cpu().numpy().tobytes() != want.numpy().tobytes():
            fail(f"WMT {name}: the card's {float(got)} over the first {n_cpu} pairs, the CPU's {float(want)}")
        res[name] = {"pairs": n, "value": float(value), "compute_ms": ms, "seconds_per_pair": ms / 1000 / n,
                     "cpu_subset_pairs": n_cpu, "equal_to_cpu_subset": True}
        if cut:
            res[name]["max_tokens"] = cut
    log(f"WMT14 en-de translation metrics: {json.dumps(res)}")
    return res


def cnndm_rouge(seed: int, vocab) -> dict:
    """ROUGE-1, -2, -L and -Lsum over 1,000 summaries of 3-4 sentences (about 55 words, one per line), stored
    in updates of 100 and scored at compute; the first 100 scored on the CPU too (equal)."""
    from metrics_tpu_torch.text import ROUGEScore

    rng = np.random.default_rng(seed + 63)
    preds, target = [], []
    for _ in range(CNNDM_SUMMARIES):
        sents = [_draw(rng, vocab, int(rng.integers(11, 18))) for _ in range(int(rng.integers(3, 5)))]
        target.append("\n".join(" ".join(s) + " ." for s in sents))
        kept = [s for s in sents if rng.random() > 0.15] or sents[:1]
        preds.append("\n".join(" ".join(_corrupt_tokens(rng, s, vocab, 0.25, 0.05, 0.1)) + " ." for s in kept))
    metric, ulog = ROUGEScore(device="cuda"), _UpdateLog()
    for i in range(0, CNNDM_SUMMARIES, 100):
        ulog.run("ROUGEScore", lambda: metric.update(preds[i:i + 100], target[i:i + 100]))
    value, ms = _timed(metric.compute)
    res = {"summaries": CNNDM_SUMMARIES, "words": sum(len(t.split()) for t in target) // CNNDM_SUMMARIES}
    res["ROUGEScore"] = ulog.summary("ROUGEScore", ms)
    res["ROUGEScore"]["values"] = {k: float(v) for k, v in value.items()}
    sub_gpu, sub_cpu = ROUGEScore(device="cuda"), ROUGEScore(device="cpu")
    sub_gpu.update(preds[:100], target[:100])
    sub_cpu.update(preds[:100], target[:100])
    got, want = sub_gpu.compute(), sub_cpu.compute()
    if any(got[k].cpu().numpy().tobytes() != want[k].numpy().tobytes() for k in want):
        fail("CNN/DailyMail ROUGE of the first 100 summaries differs between the card and the CPU")
    if not 0.0 < res["ROUGEScore"]["values"]["rougeLsum_fmeasure"] < 1.0:
        fail(f"CNN/DailyMail ROUGE-Lsum {res['ROUGEScore']['values']['rougeLsum_fmeasure']}")
    log(f"CNN/DailyMail ROUGE: {json.dumps(res)}")
    return res


def squad_dev(seed: int, vocab) -> dict:
    """SQuAD exact match and F1 over 10,570 questions with 1-3 answers, in updates of 1,057; the predictions
    are an answer (55 %, with its case or an article changed half the time), an answer with extra words (25 %)
    or other words; the first update against the CPU run."""
    from metrics_tpu_torch.text import SQuAD

    rng = np.random.default_rng(seed + 64)
    preds, target = [], []
    for q in range(SQUAD_QUESTIONS):
        answers = [" ".join(_draw(rng, vocab, int(rng.integers(1, 5)))) for _ in range(int(rng.integers(1, 4)))]
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{q}"})
        r = rng.random()
        if r < 0.55:
            text = answers[int(rng.integers(len(answers)))]
            text = ("The " + text.upper()) if rng.random() < 0.5 else text
        elif r < 0.8:
            text = " ".join(_draw(rng, vocab, 2)) + " " + answers[0]
        else:
            text = " ".join(_draw(rng, vocab, 3))
        preds.append({"prediction_text": text, "id": f"q{q}"})
    metric, ulog = SQuAD(device="cuda"), _UpdateLog()
    step = SQUAD_QUESTIONS // 10
    for i in range(0, SQUAD_QUESTIONS, step):
        ulog.run("SQuAD", lambda: metric.update(preds[i:i + step], target[i:i + step]))
    value, ms = _timed(metric.compute)
    res = {"questions": SQUAD_QUESTIONS, "SQuAD": ulog.summary("SQuAD", ms)}
    res["SQuAD"]["values"] = {k: float(v) for k, v in value.items()}
    sub_gpu, sub_cpu = SQuAD(device="cuda"), SQuAD(device="cpu")
    sub_gpu.update(preds[:step], target[:step])
    sub_cpu.update(preds[:step], target[:step])
    got, want = sub_gpu.compute(), sub_cpu.compute()
    if any(got[k].cpu().numpy().tobytes() != want[k].numpy().tobytes() for k in want):
        fail("SQuAD of the first update differs between the card and the CPU")
    if not 50.0 < res["SQuAD"]["values"]["exact_match"] < 60.0:
        fail(f"SQuAD exact match {res['SQuAD']['values']['exact_match']} against the 55 % drawn")
    log(f"SQuAD v1.1 dev: {json.dumps(res)}")
    return res


def wikitext_perplexity(seed: int) -> dict:
    """Perplexity over 30 updates of 8 x 1,024 positions x 50,257 float32 logits made on the card (standard
    normal, the target's logit raised by 8), 1 % of the positions ignored; the first row of the first update on
    the CPU and against a float64 log-softmax."""
    from metrics_tpu_torch.text import Perplexity

    g = _generator(seed + 65)
    metric, ulog = Perplexity(ignore_index=-100, device="cuda"), _UpdateLog()
    res = {"updates": WIKI_UPDATES, "logits_shape": [WIKI_BATCH, WIKI_SEQ, WIKI_VOCAB],
           "logits_gb_per_update": WIKI_BATCH * WIKI_SEQ * WIKI_VOCAB * 4 / 1e9}
    shape = (WIKI_BATCH, WIKI_SEQ)
    for i in range(WIKI_UPDATES):
        target = torch.randint(0, WIKI_VOCAB, shape, generator=g, device="cuda")
        logits = torch.randn(*shape, WIKI_VOCAB, generator=g, device="cuda")
        logits.scatter_add_(2, target[..., None], torch.full((*shape, 1), 8.0, device="cuda"))
        target = torch.where(torch.rand(shape, generator=g, device="cuda") < WIKI_IGNORE, -100, target)
        ulog.run("Perplexity", lambda: metric.update(logits, target))
        if i == 0:
            row_gpu, row_cpu = Perplexity(ignore_index=-100, device="cuda"), Perplexity(ignore_index=-100, device="cpu")
            row_gpu.update(logits[:1], target[:1])
            row_cpu.update(logits[:1].cpu(), target[:1].cpu())
            res["first_row_vs_cpu"] = _states_agree("Perplexity first row", row_gpu.metric_state,
                                                    row_cpu.metric_state, PPL_RTOL)
            t64 = target[:1].reshape(-1)
            keep = t64 != -100
            lp = torch.log_softmax(logits[:1].reshape(-1, WIKI_VOCAB).double(), -1)
            exact = float(-lp[keep].gather(1, t64[keep][:, None]).sum())
            res["first_row_vs_float64"] = abs(float(row_gpu.total_log_probs) - exact) / exact
            if res["first_row_vs_float64"] > PPL_RTOL:
                fail(f"Perplexity's first row {float(row_gpu.total_log_probs)} against float64 {exact}")
        del logits
    value, ms = _timed(metric.compute)
    res["Perplexity"] = ulog.summary("Perplexity", ms)
    res["Perplexity"].update({"value": float(value), "tokens_scored": int(metric.count),
                              "bound_ms_per_update": WIKI_BATCH * WIKI_SEQ * WIKI_VOCAB * 4 / HBM_BYTES_PER_S * 1e3})
    if not (math.isfinite(float(value)) and 1.0 < float(value) < WIKI_VOCAB):
        fail(f"WikiText-103 perplexity {float(value)}")
    log(f"WikiText-103 perplexity: {json.dumps(res)}")
    return res


def _mixtures(g: torch.Generator, n: int, spk: int):
    """(estimates, sources): sources of unit variance; each estimate its source plus 0.2 of the others and 0.1
    of noise, the estimates' order shuffled in half of the mixtures; and the aligned estimates."""
    sources = torch.randn(n, spk, MIX_LEN, generator=g, device="cuda")
    leak = (sources.sum(1, keepdim=True) - sources) * 0.2
    aligned = sources + leak + 0.1 * torch.randn(n, spk, MIX_LEN, generator=g, device="cuda")
    order = torch.argsort(torch.rand(n, spk, generator=g, device="cuda"), dim=1)
    swap = torch.rand(n, 1, generator=g, device="cuda") < 0.5
    order = torch.where(swap, order, torch.arange(spk, device="cuda"))
    return torch.gather(aligned, 1, order[..., None].expand_as(aligned)), sources, aligned


def _audio_states_agree(name, gpu, cpu, atol_each, rtol=0.0):
    """``total`` equal; ``sum_value`` within ``atol_each`` dB per value summed, or within ``rtol``."""
    if int(gpu.total) != int(cpu.total):
        fail(f"{name}: {int(gpu.total)} values on one side, {int(cpu.total)} on the other")
    return _agree(f"{name}[sum_value]", gpu.sum_value.cpu(), cpu.sum_value.cpu(), False, rtol,
                  atol_each * int(cpu.total))


def libri2mix(seed: int) -> dict:
    """SNR, SI-SDR, SI-SNR, SA-SDR and PIT over SI-SDR in one collection, each also alone (its update's time and
    host syncs), SDR with 512 taps and C-SI-SNR on 512-point STFTs, over 3,000 two-source mixtures of 32,000
    samples in updates of 16; the SI-SDR stream also in four shards; the first update against the CPU run."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.audio import (
        ComplexScaleInvariantSignalNoiseRatio, PermutationInvariantTraining, ScaleInvariantSignalDistortionRatio,
        ScaleInvariantSignalNoiseRatio, SignalDistortionRatio, SignalNoiseRatio, SourceAggregatedSignalDistortionRatio,
    )
    from metrics_tpu_torch.functional.audio import permutation_invariant_training, scale_invariant_signal_distortion_ratio

    makers = {
        "SignalNoiseRatio": lambda d: SignalNoiseRatio(device=d),
        "ScaleInvariantSignalDistortionRatio": lambda d: ScaleInvariantSignalDistortionRatio(device=d),
        "ScaleInvariantSignalNoiseRatio": lambda d: ScaleInvariantSignalNoiseRatio(device=d),
        "SourceAggregatedSignalDistortionRatio": lambda d: SourceAggregatedSignalDistortionRatio(device=d),
        "PermutationInvariantTraining": lambda d: PermutationInvariantTraining(scale_invariant_signal_distortion_ratio,
                                                                               device=d),
    }
    aligned_makers = {"SignalDistortionRatio": lambda d: SignalDistortionRatio(filter_length=MIX_SDR_TAPS, device=d),
                      "ComplexScaleInvariantSignalNoiseRatio": lambda d: ComplexScaleInvariantSignalNoiseRatio(device=d)}
    coll = MetricCollection({k: m("cuda") for k, m in makers.items()}, compute_groups=False)
    single = {k: m("cuda") for k, m in {**makers, **aligned_makers}.items()}
    shards = [ScaleInvariantSignalDistortionRatio(device="cuda") for _ in range(TEXT_SHARDS)]
    window = torch.hann_window(MIX_NFFT, device="cuda")

    def spectra(x):
        spec = torch.stft(x.reshape(-1, MIX_LEN), MIX_NFFT, hop_length=MIX_NFFT // 4, window=window,
                          return_complex=True)
        return spec.reshape(*x.shape[:2], *spec.shape[1:])

    g = _generator(seed + 66)
    ulog, res = _UpdateLog(), {"mixtures": MIX_N, "samples": MIX_LEN, "sample_rate": MIX_FS}
    steps = -(-MIX_N // MIX_UPDATE)
    for i in range(steps):
        n = min(MIX_UPDATE, MIX_N - i * MIX_UPDATE)
        est, src, aligned = _mixtures(g, n, MIX_SPK)
        spec_est, spec_src = spectra(aligned), spectra(src)
        inputs = {**{k: (est, src) for k in makers}, "SignalDistortionRatio": (aligned, src),
                  "ComplexScaleInvariantSignalNoiseRatio": (spec_est, spec_src)}
        ulog.run("MetricCollection[Libri2Mix]", lambda: coll.update(est, src))
        for name, metric in single.items():
            ulog.run(name, lambda: metric.update(*inputs[name]))
        shards[i % TEXT_SHARDS].update(est, src)
        if i == 0:
            res["max_abs_diff_vs_cpu_first_update"] = {}
            for name, make in {**makers, **aligned_makers}.items():
                cpu = make("cpu")
                cpu.update(*(x.cpu() for x in inputs[name]))
                atol = SDR_ATOL if name == "SignalDistortionRatio" else AUDIO_DB_ATOL
                res["max_abs_diff_vs_cpu_first_update"][name] = _audio_states_agree(
                    f"Libri2Mix {name} first update", single[name], cpu, atol)
            best_g, perm_g = permutation_invariant_training(est, src, scale_invariant_signal_distortion_ratio)
            best_c, perm_c = permutation_invariant_training(est.cpu(), src.cpu(), scale_invariant_signal_distortion_ratio)
            if not torch.equal(perm_g.cpu(), perm_c):
                fail("Libri2Mix PIT: the card's permutations differ from the CPU's")
            res["pit_permutations_equal_cpu_first_update"] = True
    for name in AUDIO_NO_SYNC:
        if name in ulog.syncs and any(ulog.syncs[name][1:]):
            fail(f"Libri2Mix {name}: a later update synchronized with the host {max(ulog.syncs[name][1:])} times")
    values, ms = _timed(coll.compute)
    res["MetricCollection[Libri2Mix]"] = ulog.summary("MetricCollection[Libri2Mix]", ms)
    res["MetricCollection[Libri2Mix]"]["values"] = {k: float(v) for k, v in values.items()}
    for name, metric in single.items():
        value, ms = _timed(metric.compute)
        res[name] = ulog.summary(name, ms)
        res[name]["value"] = float(value)
        if name in values and not abs(float(value) - float(values[name])) <= 1e-6 * abs(float(value)):
            fail(f"Libri2Mix {name}: {float(value)} alone, {float(values[name])} in the collection")
        if not math.isfinite(float(value)):
            fail(f"Libri2Mix {name} is {float(value)}")
    if not res["PermutationInvariantTraining"]["value"] >= res["ScaleInvariantSignalDistortionRatio"]["value"] - 1e-4:
        fail("Libri2Mix: PIT's best permutation scores below the given order")
    merged = _merged(shards)
    res["SI-SDR_merged_4_shards"] = _audio_states_agree("SI-SDR merged", merged, single[
        "ScaleInvariantSignalDistortionRatio"], 0.0, MERGE_RTOL)
    log(f"Libri2Mix: {json.dumps(res)}")
    return res


def libri3mix(seed: int) -> dict:
    """PIT over SI-SDR with three sources (the assignment solved on the host): 160 mixtures in updates of 16;
    one host synchronization an update (the metric matrix read once); the first update against the CPU run."""
    from metrics_tpu_torch.audio import PermutationInvariantTraining
    from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio

    g = _generator(seed + 67)
    metric, ulog = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device="cuda"), _UpdateLog()
    res = {"mixtures": MIX3_N, "sources": 3}
    for i in range(MIX3_N // MIX_UPDATE):
        est, src, _ = _mixtures(g, MIX_UPDATE, 3)
        ulog.run("PermutationInvariantTraining", lambda: metric.update(est, src))
        if i == 0:
            cpu = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device="cpu")
            cpu.update(est.cpu(), src.cpu())
            res["max_abs_diff_vs_cpu_first_update"] = _audio_states_agree("Libri3Mix PIT first update", metric, cpu,
                                                                          AUDIO_DB_ATOL)
    value, ms = _timed(metric.compute)
    res["PermutationInvariantTraining"] = ulog.summary("PermutationInvariantTraining", ms)
    res["PermutationInvariantTraining"]["value"] = float(value)
    if any(s != 1 for s in ulog.syncs["PermutationInvariantTraining"][1:]):
        fail(f"Libri3Mix PIT: host syncs per later update {ulog.syncs['PermutationInvariantTraining'][1:]}, not 1")
    log(f"Libri3Mix PIT: {json.dumps(res)}")
    return res


def _speech_like(rng: np.random.Generator, n: int, fs: int, seconds: float) -> np.ndarray:
    """(n, seconds * fs) noise in syllable-rate bursts (3-5 Hz) with a silent stretch of 0.4 s at a random
    place, float32."""
    length = int(seconds * fs)
    t = np.arange(length) / fs
    rate = rng.uniform(3.0, 5.0, (n, 1))
    x = np.clip(np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi, (n, 1))), 0, None) * rng.standard_normal((n, length))
    starts = rng.integers(0, length - int(0.4 * fs), n)
    for row, s in zip(x, starts):
        row[s:s + int(0.4 * fs)] = 0.0
    return x.astype(np.float32)


def stoi_speech(seed: int) -> dict:
    """STOI and ESTOI over 200 utterances of 3 s at 16 kHz with noise at 5 dB SNR, in updates of 20 (resampled
    to 10 kHz and silent frames removed on the host); the first update against the CPU run; STOI of the clean
    utterances against themselves is 1."""
    from metrics_tpu_torch.audio import ShortTimeObjectiveIntelligibility
    from metrics_tpu_torch.functional.audio import short_time_objective_intelligibility

    rng = np.random.default_rng(seed + 68)
    clean = _speech_like(rng, STOI_N, STOI_FS, STOI_SECONDS)
    power = (clean.astype(np.float64) ** 2).mean(1, keepdims=True)
    noisy = (clean + np.sqrt(power / 10 ** (STOI_SNR_DB / 10)) * rng.standard_normal(clean.shape)).astype(np.float32)
    clean_t, noisy_t = torch.from_numpy(clean).cuda(), torch.from_numpy(noisy).cuda()
    ulog, res = _UpdateLog(), {"utterances": STOI_N, "seconds": STOI_SECONDS, "snr_db": STOI_SNR_DB}
    for name, extended in (("STOI", False), ("ESTOI", True)):
        metric = ShortTimeObjectiveIntelligibility(STOI_FS, extended=extended, device="cuda")
        for i in range(0, STOI_N, STOI_UPDATE):
            p, t = noisy_t[i:i + STOI_UPDATE], clean_t[i:i + STOI_UPDATE]
            ulog.run(name, lambda: metric.update(p, t))
            if i == 0:
                got = short_time_objective_intelligibility(p, t, STOI_FS, extended)
                want = short_time_objective_intelligibility(p.cpu(), t.cpu(), STOI_FS, extended)
                res[f"{name}_max_abs_diff_vs_cpu_first_update"] = _agree(f"{name} first update", got.cpu(), want,
                                                                         False, 0.0, STOI_ATOL)
                same = short_time_objective_intelligibility(t, t, STOI_FS, extended)
                res[f"{name}_clean_against_itself_max_abs_from_1"] = float((same - 1).abs().max())
                if res[f"{name}_clean_against_itself_max_abs_from_1"] > 1e-6:
                    fail(f"{name} of clean speech against itself is not 1: {same.tolist()}")
        value, ms = _timed(metric.compute)
        res[name] = ulog.summary(name, ms)
        res[name].update({"value": float(value), "update_ms_per_utterance": float(sum(ulog.ms[name])) / STOI_N})
        if not 0.0 < float(value) < 1.0:
            fail(f"{name} at 5 dB SNR is {float(value)}")
    log(f"STOI and ESTOI: {json.dumps(res)}")
    return res


def srmr_speech(seed: int) -> dict:
    """SRMR with ``norm=False`` and ``norm=True`` over 100 utterances of 4 s at 16 kHz (23 cochlear filters),
    in updates of 10; the first two utterances against the CPU run."""
    from metrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
    from metrics_tpu_torch.functional.audio import speech_reverberation_modulation_energy_ratio

    rng = np.random.default_rng(seed + 69)
    x = torch.from_numpy(_speech_like(rng, SRMR_N, SRMR_FS, SRMR_SECONDS)).cuda()
    ulog, res = _UpdateLog(), {"utterances": SRMR_N, "seconds": SRMR_SECONDS, "cochlear_filters": 23}
    for norm in (False, True):
        name = f"SRMR[norm={norm}]"
        metric = SpeechReverberationModulationEnergyRatio(SRMR_FS, norm=norm, device="cuda")
        for i in range(0, SRMR_N, SRMR_UPDATE):
            batch = x[i:i + SRMR_UPDATE]
            ulog.run(name, lambda: metric.update(batch))
        got = speech_reverberation_modulation_energy_ratio(x[:2], SRMR_FS, norm=norm)
        want = speech_reverberation_modulation_energy_ratio(x[:2].cpu(), SRMR_FS, norm=norm)
        value, ms = _timed(metric.compute)
        res[name] = ulog.summary(name, ms)
        res[name].update({"value": float(value), "max_abs_diff_vs_cpu_first_2": _agree(
            f"{name} first two", got.cpu(), want, False, SRMR_RTOL, 0.0)})
        if not (math.isfinite(float(value)) and float(value) > 0):
            fail(f"{name} is {float(value)}")
    log(f"SRMR: {json.dumps(res)}")
    return res


def gated_audio() -> dict:
    """PESQ, DNSMOS and NISQA, classes and functions, raise ``ModuleNotFoundError`` without ``pesq`` or
    ``onnxruntime``."""
    import importlib.util

    import metrics_tpu_torch.audio as ta
    import metrics_tpu_torch.functional.audio as tfa

    wav = torch.zeros(16000, device="cuda")
    cases = [("PerceptualEvaluationSpeechQuality", "pesq", lambda: ta.PerceptualEvaluationSpeechQuality(16000, "wb", device="cuda")),
             ("perceptual_evaluation_speech_quality", "pesq",
              lambda: tfa.perceptual_evaluation_speech_quality(wav, wav, 16000, "wb")),
             ("DeepNoiseSuppressionMeanOpinionScore", "onnxruntime",
              lambda: ta.DeepNoiseSuppressionMeanOpinionScore(16000, device="cuda")),
             ("deep_noise_suppression_mean_opinion_score", "onnxruntime",
              lambda: tfa.deep_noise_suppression_mean_opinion_score(wav, 16000)),
             ("NonIntrusiveSpeechQualityAssessment", "onnxruntime",
              lambda: ta.NonIntrusiveSpeechQualityAssessment(16000, device="cuda")),
             ("non_intrusive_speech_quality_assessment", "onnxruntime",
              lambda: tfa.non_intrusive_speech_quality_assessment(wav, 16000))]
    res = {}
    for name, package, call in cases:
        if importlib.util.find_spec(package) is not None:
            res[name] = f"{package} is installed"
            continue
        try:
            call()
        except ModuleNotFoundError as err:
            res[name] = str(err)
        else:
            fail(f"{name} did not raise without {package}")
    log(f"gated audio metrics: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------------------- phase 5
# ----------------------------------------------------------------------------- phase 4, observe and durability
WATCHED_UPDATES = 3  # later updates watched in CUDA's sync debug mode, each way (telemetry off and on, guarded)
HOST_MS_UPDATES = 20  # host-timed updates of each variant, in the turns off, on, on, off
APART: dict = {}  # sections whose launches are counted apart from the main path's


def _syncs(fn) -> int:
    """Host synchronizations of ``fn()`` under CUDA's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _host_ms(fn) -> float:
    """Host ms of ``fn()``: the time to enqueue it, the card idle before and waited for after, outside the
    timing."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = 1000 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ms


def _in_turns(variants: dict, n: int, setup: dict = None) -> dict:
    """Median host ms of each variant's call, ``n`` calls a turn, in the turns a, b, b, a (for two);
    ``setup[name]()``, untimed, starts each of its turns."""
    names = list(variants)
    order = names + names[::-1]
    times = {k: [] for k in names}
    for name in order:
        if setup:
            setup[name]()
        times[name] += [_host_ms(variants[name]) for _ in range(n)]
    return {k: float(np.median(v)) for k, v in times.items()}


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _counting_updates(collection, calls: dict) -> None:
    """Wrap each member's ``update`` to count, in ``calls`` by class, the calls the collection makes."""
    for name, metric in collection.items():
        inner = metric.update
        calls[type(metric).__name__] = 0

        def counted(*args, _inner=inner, _key=type(metric).__name__, **kwargs):
            calls[_key] += 1
            return _inner(*args, **kwargs)

        object.__setattr__(metric, "update", counted)


def _nccl_world_of_one():
    """An NCCL process group of one in a fresh store; the caller destroys it."""
    import tempfile

    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/store", world_size=1, rank=0)
    return dist


def observe_and_durability(seed: int, wrappers: dict, imagenet) -> dict:
    """The observe runtime and durability over the main path's inputs: the ImageNet-1k collection and the
    COCO-80 AP + AUROC collection under ``observe.scope()`` (snapshot counts, the Chrome trace, the host syncs
    that telemetry adds, the ``record_function`` range around the binned-counts launch, the latency quantiles,
    a flagship update's host ms off and on); input guards (states bit-equal after a NaN batch, host syncs and
    host ms guarded and not, ``raise_on_host``); checkpoints from the card (the ImageNet and COCO
    collections, a 200 MB cat state, restored on the card and on the CPU with equal fingerprints; an exact
    AUROC and MAP at COCO val2017 scale saved and, as in the JAX package, refused; a corrupt file, another
    config, the periodic checkpointer); the watchdog over the run's recorder. Launches here are counted apart
    from the main path's."""
    dev = torch.device("cuda")
    for wrapper in wrappers.values():
        wrapper.launches = 0
    rng = np.random.default_rng(seed + 90)
    imagenet_dev = [(p.to(dev), t.to(dev)) for p, t in imagenet]
    coco = [coco80_batch(rng) for _ in range(PRC_STEPS)]
    coco_dev = [(p.to(dev), t.to(dev)) for p, t in coco]
    acc_batch = (torch.from_numpy(rng.random((ACC_BATCH, ACC_CLASSES), dtype=np.float32)).to(dev),
                 torch.from_numpy(rng.integers(0, ACC_CLASSES, ACC_BATCH)).to(dev))
    res = {}
    t0 = time.perf_counter()
    res["telemetry"] = _telemetry_checks(imagenet_dev, coco_dev, acc_batch, dev)
    res["guards"] = _guard_checks(coco_dev, acc_batch, dev)
    res["checkpoints"] = _checkpoint_checks(seed, imagenet_dev, coco_dev, dev)
    res["watchdog"] = _watchdog_checks(acc_batch, dev)
    res["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    res["launches_counted_apart"] = {k: w.launches for k, w in wrappers.items()}
    if res["launches_counted_apart"]["binned_counts"] < 1:
        fail("observe_and_durability: the COCO-80 collection launched no binned counts")
    return res


def _telemetry_checks(imagenet_dev, coco_dev, acc_batch, dev) -> dict:
    import tempfile

    from metrics_tpu_torch import MetricCollection, observe
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.ops.profile import kernels_inside

    out = {}
    with observe.scope():
        img, coco = MetricCollection(imagenet_members(dev)), coco80_collection(dev)
        calls: dict = {}
        _counting_updates(img, calls)
        _counting_updates(coco, calls)
        for p, t in imagenet_dev:
            img.update(p, t)
        for p, t in coco_dev:
            coco.update(p, t)
        img.compute()
        coco.compute()
        dist = _nccl_world_of_one()
        try:
            acc = img["MulticlassAccuracy"]
            acc.sync(distributed_available=True)
            acc.unsync()
        finally:
            dist.destroy_process_group()
        snap = observe.snapshot()
        made = {k: v for k, v in calls.items() if v}
        if snap["counters"].get("update_eager") != made:
            fail(f"telemetry: update counts {snap['counters'].get('update_eager')}, updates made {made}")
        trace = json.loads(json.dumps(observe.timeline()))
        phases = {e["cat"] for e in trace["traceEvents"]}
        if not {"update", "compute", "sync", "gather_all"} <= phases:
            fail(f"telemetry: the timeline's phases are {sorted(phases)}")
        out.update({"update_counts": made, "spans_total": trace["otherData"]["spans_total"],
                    "timeline_phases": sorted(phases), "sync_bytes": snap["counters"].get("sync_bytes", {}),
                    "explicit_transfers": snap["counters"].get("explicit_transfer", {})})
        # what telemetry adds to a later update's host syncs: each collection's updates watched off and on
        syncs = {}
        for name, col, batches in (("ImageNet collection", img, imagenet_dev), ("COCO-80 collection", coco, coco_dev)):
            for mode in ("off", "on"):
                (observe.disable if mode == "off" else observe.enable)()
                syncs[f"{name}[{mode}]"] = max(_syncs(lambda: col.update(*batches[i % len(batches)]))
                                               for i in range(WATCHED_UPDATES))
            observe.enable()
            if syncs[f"{name}[on]"] != syncs[f"{name}[off]"]:
                fail(f"telemetry adds host syncs to a later {name} update: {syncs}")
        out["host_syncs_per_later_update"] = syncs
        # the span's profiler range around the binned-counts launch
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            coco.update(*coco_dev[0])
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
            with open(os.path.join(tmp, "trace.json")) as fh:
                ktrace = json.load(fh)
        names = {e.get("name") for e in ktrace.get("traceEvents", [])}
        if "update:MultilabelAveragePrecision" not in names:
            fail("telemetry: no update:MultilabelAveragePrecision range in the profiler's trace")
        inside = kernels_inside(ktrace, "update:MultilabelAveragePrecision")
        binned = sum("binned_counts" in k for k in inside)
        out["kernels_inside_update_range"] = {"binned_counts": binned, "others": len(inside) - binned}
        if binned != 1:
            fail(f"telemetry: {binned} binned-counts launches inside the update range, expected 1")
        latency = observe.snapshot()["latency"]
        out["latency_ms"] = {f"{phase}:{label}": {"count": agg["count"], "p50": 1000 * agg["p50_s"],
                                                   "p99": 1000 * agg["p99_s"]}
                             for phase, by in latency.items() for label, agg in by.items()}
        # a later flagship update (MulticlassAccuracy, 10 classes, micro) on the host, telemetry off and on
        flag = tc.MulticlassAccuracy(num_classes=ACC_CLASSES, average="micro", device=dev)
        for _ in range(3):
            flag.update(*acc_batch)

        def update():
            flag.update(*acc_batch)

        out["flagship_update_host_ms"] = _in_turns({"off": update, "on": update}, HOST_MS_UPDATES,
                                                   {"off": observe.disable, "on": observe.enable})
    log(f"observe telemetry: {json.dumps(out)}")
    return out


def _guard_checks(coco_dev, acc_batch, dev) -> dict:
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.resilience import GUARD_STATE, PoisonedInputError, install_guard, poisoned_count

    def acc():
        return tc.MulticlassAccuracy(num_classes=ACC_CLASSES, average="micro", device=dev)

    def ap():
        return tc.MultilabelAveragePrecision(num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, device=dev)

    def poison(batch):
        preds = batch[0].clone()
        preds[0, 0] = float("nan")
        return preds, batch[1]

    out = {"bit_equal_after_nan_batch": {}, "host_syncs_per_later_update": {}, "host_ms": {}}
    for name, make, batch in (("MulticlassAccuracy", acc, acc_batch), ("MultilabelAveragePrecision", ap, coco_dev[0])):
        m = install_guard(make(), "skip_batch")
        m.update(*batch)
        m.update(*batch)
        before = {k: v.clone() for k, v in m.metric_state.items()}
        m.update(*poison(batch))
        same = all(_bit_equal(v, m.metric_state[k]) for k, v in before.items() if k != GUARD_STATE)
        if not same or poisoned_count(m) != 1:
            fail(f"guard skip_batch: {name} states changed by the NaN batch or counter {poisoned_count(m)}")
        out["bit_equal_after_nan_batch"][name] = True
        for policy in (None, "skip_batch", "propagate"):
            g = make() if policy is None else install_guard(make(), policy)
            g.update(*batch)
            out["host_syncs_per_later_update"][f"{name}[{policy or 'unguarded'}]"] = max(
                _syncs(lambda: g.update(*batch)) for _ in range(WATCHED_UPDATES))
        base = out["host_syncs_per_later_update"][f"{name}[unguarded]"]
        for policy in ("skip_batch", "propagate"):
            if out["host_syncs_per_later_update"][f"{name}[{policy}]"] != base:
                fail(f"guard {policy} adds host syncs to a later {name} update: {out['host_syncs_per_later_update']}")
        plain, guarded = make(), install_guard(make(), "skip_batch")
        plain.update(*batch)
        guarded.update(*batch)
        out["host_ms"][name] = _in_turns({"unguarded": lambda: plain.update(*batch),
                                          "skip_batch": lambda: guarded.update(*batch)}, HOST_MS_UPDATES)
    loud = install_guard(acc(), "raise_on_host")
    loud.update(*acc_batch)
    before = {k: v.clone() for k, v in loud.metric_state.items()}
    try:
        loud.update(*poison(acc_batch))
        fail("guard raise_on_host: a NaN batch did not raise PoisonedInputError")
    except PoisonedInputError:
        pass
    if not all(_bit_equal(v, loud.metric_state[k]) for k, v in before.items() if k != GUARD_STATE):
        fail("guard raise_on_host: the states changed")
    out["raise_on_host"] = {"raised": "PoisonedInputError", "states_intact": True, "counter": poisoned_count(loud),
                            "host_syncs_per_later_update": max(_syncs(lambda: loud.update(*acc_batch))
                                                               for _ in range(WATCHED_UPDATES))}
    log(f"guards: {json.dumps(out)}")
    return out


def _fingerprints(obj) -> dict:
    from metrics_tpu_torch import MetricCollection

    if isinstance(obj, MetricCollection):
        return {name: m.state_fingerprint() for name, m in obj.items()}
    return {type(obj).__name__: obj.state_fingerprint()}


def _round_trip(name, obj, make, path, rtol) -> dict:
    """Save ``obj`` from the card; restore into ``make("cuda")`` and ``make("cpu")``; fingerprints and
    ``compute()`` held to the original's."""
    from metrics_tpu_torch.resilience import restore_checkpoint, save_checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(obj, path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    row = {"mb": mb, "save_s": save_s, "save_mb_per_s": mb / save_s}
    want_fp, want = _fingerprints(obj), obj.compute()
    want = {k: v.cpu() for k, v in want.items()} if isinstance(want, dict) else want.cpu()
    for where in ("cuda", "cpu"):
        target = make(where)
        t0 = time.perf_counter()
        restore_checkpoint(target, path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if _fingerprints(target) != want_fp:
            fail(f"checkpoint {name}: the state fingerprints restored on {where} differ")
        got = target.compute()
        exact = where == "cuda"
        diff = (_agree_dict(f"{name} restored on {where}", got, want, exact, rtol) if isinstance(want, dict)
                else _agree(f"{name} restored on {where}", got, want, exact, rtol))
        row[f"restore_s[{where}]"] = restore_s
        row[f"restore_mb_per_s[{where}]"] = mb / restore_s
        row[f"max_abs_diff[{where}]"] = diff
    log(f"checkpoint {name}: {json.dumps(row)}")
    return row


def _refused_restore(name, obj, make, path, match) -> dict:
    """Save ``obj``; its restore into ``make("cuda")`` and ``make("cpu")`` must raise the JAX package's
    ``IncompatibleCheckpointError`` whose message holds ``match``."""
    from metrics_tpu_torch.resilience import IncompatibleCheckpointError, restore_checkpoint, save_checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(obj, path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    for where in ("cuda", "cpu"):
        target = make(where)
        try:
            restore_checkpoint(target, path)
            fail(f"checkpoint {name}: restored on {where}, where the JAX package refuses it")
        except IncompatibleCheckpointError as exc:
            if match not in str(exc):
                fail(f"checkpoint {name}: refused for another reason: {exc}")
        if target.update_count != 0:
            fail(f"checkpoint {name}: the refused restore changed the target")
    row = {"mb": mb, "save_s": save_s, "save_mb_per_s": mb / save_s, "restore": "IncompatibleCheckpointError",
           "reason": match}
    log(f"checkpoint {name}: {json.dumps(row)}")
    return row


def _checkpoint_checks(seed, imagenet_dev, coco_dev, dev) -> dict:
    import shutil
    import tempfile

    from metrics_tpu_torch import CatMetric, MetricCollection
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.detection import MeanAveragePrecision
    from metrics_tpu_torch.resilience import (
        CorruptCheckpointError,
        IncompatibleCheckpointError,
        PeriodicCheckpointer,
        SnapshotPolicy,
        restore_checkpoint,
    )

    out = {}
    tmp = tempfile.mkdtemp()
    try:
        img = MetricCollection(imagenet_members(dev))
        for p, t in imagenet_dev:
            img.update(p, t)
        path = os.path.join(tmp, "imagenet.ckpt")
        out["ImageNet-1k collection"] = _round_trip("ImageNet-1k collection", img,
                                                    lambda d: MetricCollection(imagenet_members(d)), path,
                                                    STAT_RTOL)
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0xFF
        with open(os.path.join(tmp, "flipped.ckpt"), "wb") as fh:
            fh.write(bytes(blob))
        try:
            restore_checkpoint(MetricCollection(imagenet_members(dev)), os.path.join(tmp, "flipped.ckpt"))
            fail("checkpoint: a flipped payload byte was restored")
        except CorruptCheckpointError as exc:
            out["flipped_payload_byte"] = str(exc).rsplit(": ", 1)[-1]
        other = imagenet_members(dev)
        other[0] = tc.MulticlassAccuracy(num_classes=IN_CLASSES, average="macro", device=dev)
        try:
            restore_checkpoint(MetricCollection(other), path)
            fail("checkpoint: restored into another configuration")
        except IncompatibleCheckpointError as exc:
            out["another_config"] = "config fingerprint mismatch" if "fingerprint" in str(exc) else str(exc)
        cat = CatMetric(device=dev)
        for p, _ in imagenet_dev:
            cat.update(p)
        out["CatMetric[50,000 x 1000 scores]"] = _round_trip(
            "CatMetric[50,000 x 1000 scores]", cat, lambda d: CatMetric(device=d), os.path.join(tmp, "cat.ckpt"),
            0.0)
        del cat
        exact = tc.MulticlassAUROC(num_classes=IN_CLASSES, thresholds=None, device=dev)
        for p, t in imagenet_dev:
            exact.update(p, t)
        out["MulticlassAUROC[exact, 50,000 x 1000]"] = _refused_restore(
            "MulticlassAUROC[exact, 50,000 x 1000]", exact,
            lambda d: tc.MulticlassAUROC(num_classes=IN_CLASSES, thresholds=None, device=d),
            os.path.join(tmp, "auroc.ckpt"), "state 'target' expects dtype float32")
        del exact
        coco = coco80_collection(dev)
        for p, t in coco_dev:
            coco.update(p, t)
        out["COCO-80 collection"] = _round_trip("COCO-80 collection", coco, coco80_collection,
                                                os.path.join(tmp, "coco.ckpt"), CURVE_RTOL)
        periodic = MetricCollection(imagenet_members(dev))
        ck = PeriodicCheckpointer(periodic, os.path.join(tmp, "periodic.ckpt"), SnapshotPolicy(every_n_updates=2))
        fired = []
        for p, t in imagenet_dev:
            periodic.update(p, t)
            fired.append(ck.step())
        restored = restore_checkpoint(MetricCollection(imagenet_members("cpu")), os.path.join(tmp, "periodic.ckpt"))
        count = restored["MulticlassAccuracy"].update_count
        if ck.saves != 2 or fired != [False, True, False, True, False] or count != 4:
            fail(f"PeriodicCheckpointer: {ck.saves} saves, fired {fired}, restored update count {count}")
        out["periodic_every_2_over_5"] = {"saves": ck.saves, "fired": fired, "restored_update_count": count}
        images = coco_images(np.random.default_rng(seed + 7))
        per = COCO_IMAGES // COCO_STEPS
        detection = MeanAveragePrecision(device=dev)
        for i in range(COCO_STEPS):
            part = [({k: v.to(dev) for k, v in p.items()}, {k: v.to(dev) for k, v in t.items()})
                    for p, t in images[i * per:(i + 1) * per]]
            detection.update([p for p, _ in part], [t for _, t in part])
        out["MeanAveragePrecision[COCO val2017, 5,000 images]"] = _refused_restore(
            "MeanAveragePrecision[COCO val2017, 5,000 images]", detection,
            lambda d: MeanAveragePrecision(device=d), os.path.join(tmp, "map.ckpt"),
            "state 'detection_label' expects dtype float32")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _watchdog_checks(acc_batch, dev) -> dict:
    from metrics_tpu_torch import observe
    from metrics_tpu_torch import classification as tc

    out = {}
    with observe.scope():
        rule = observe.SloRule("update_p99", "update_p99_s", "<=", 1.0, for_ticks=1)
        wd = observe.install_watchdog(observe.Watchdog(rules=list(observe.DEFAULT_SLOS) + [rule], min_interval_s=0.0))
        try:
            m = tc.MulticlassAccuracy(num_classes=ACC_CLASSES, average="micro", device=dev)
            for _ in range(8):
                m.update(*acc_batch)
            p50 = observe.snapshot()["latency"]["update"]["MulticlassAccuracy"]["p50_s"]
            rule.threshold = p50 / 2  # below the measured median: the next window's p99 breaches it
            wd.sample()  # seeds the window
            verdicts = []
            for threshold in (rule.threshold, 60.0):
                rule.threshold = threshold
                for _ in range(8):
                    m.update(*acc_batch)
                signals = wd.sample()
                health = wd.health()
                verdicts.append({"threshold_ms": 1000 * threshold, "update_p99_ms": 1000 * signals["update_p99_s"],
                                 "verdict": health["verdict"], "firing": health["firing"]})
            events = [e["kind"] for e in observe.snapshot()["events"] if e["kind"].startswith("slo_")]
            if [v["firing"] for v in verdicts] != [["update_p99"], []] or events != ["slo_fired", "slo_resolved"]:
                fail(f"watchdog: the update p99 rule did not fire and resolve: {verdicts}, {events}")
            defaults = {r.name: signals.get(r.signal) for r in observe.DEFAULT_SLOS}
            out = {"update_p50_ms": 1000 * p50, "verdicts": verdicts, "events": events,
                   "default_slos_signals": defaults, "samples": wd.health()["samples"]}
        finally:
            observe.uninstall_watchdog()
    log(f"watchdog: {json.dumps(out)}")
    return out


# ----------------------------------------------------------------------------- phase 4, the fleet engine
# the fleet configurations of the JAX package's benchmark (bench.py:62-80): 10,000 streams of two classes, batch
# 16, 3 ticks, 256 churned; the 1,000-stream recovery fleet; two-scalar sessions over 8 shards (the JAX package's
# 100,000, cut to 25,000 so that the script's time limit holds the serve and model-based sections too)
FLEET_STREAMS, FLEET_SMALL, FLEET_TICKS, FLEET_CHURN, FLEET_BATCH = 10_000, 1_000, 3, 256, 16
FLEET_CAPACITY = 8192  # the 5,000-session buckets padded to a power of two
FLEET_ORACLE_EVERY = 50  # one session in 50 also runs as a per-instance oracle on the card
FLEET_CPU_SUBSET = 256  # sessions of each class rerun through a CPU engine
SSIM_SESSIONS, SSIM_FLEET_SHAPE, SSIM_FLEET_TICKS = 512, (1, 3, 256, 256), 2
MCAUROC_SESSIONS, MCAUROC_CLASSES, MCAUROC_THRESHOLDS, MCAUROC_BATCH, MCAUROC_TICKS = 1000, 10, 200, 256, 2
SHARDED_SESSIONS, SHARDED_SHARDS, SHARDED_TICKS, SHARDED_ACTIVE, SHARDED_CHURN = 25_000, 8, 4, 2048, 512
SHARDED_CAPACITY = 1 << 14
SHARDED_ORACLE_EVERY = 500


def _stream_mean_class():
    """The JAX package's benchmark metric (bench.py:677-702) in the port: a two-scalar stream mean."""
    from metrics_tpu_torch import Metric

    class StreamMean(Metric):
        full_state_update = False

        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("count", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + torch.sum(x)
            self.count = self.count + x.shape[0]

        def compute(self):
            return self.total / torch.clamp(self.count, min=1.0)

    # pickled by reference (journals, checkpoints): a global of the script's own module
    StreamMean.__module__, StreamMean.__qualname__ = __name__, "StreamMean"
    globals()["StreamMean"] = StreamMean
    return StreamMean


def _host_generator(seed: int) -> torch.Generator:
    """A CPU generator: the fleet's batches are drawn on the host (the same numbers for the card's runs and the
    CPU's) and moved to the device a column at a time."""
    return torch.Generator().manual_seed(seed)


def _dev_sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _wall(fn, dev):
    """``fn()`` between two synchronizations of ``dev``; returns (result, ms)."""
    _dev_sync(dev)
    t0 = time.perf_counter()
    result = fn()
    _dev_sync(dev)
    return result, 1000 * (time.perf_counter() - t0)


def _watched(fn, dev, wrappers):
    """``fn()`` with the kernels' launches counted from 0 and, on the card, its host synchronizations (CUDA's
    sync debug mode); returns (result, ms, launches, syncs)."""
    for w in wrappers.values():
        w.launches = 0
    box = {}
    if torch.device(dev).type == "cuda":
        t0 = time.perf_counter()
        syncs = _syncs(lambda: box.setdefault("r", fn()))
        ms = 1000 * (time.perf_counter() - t0)
    else:
        box["r"], ms = _wall(fn, dev)
        syncs = None
    return box["r"], ms, {k: w.launches for k, w in wrappers.items()}, syncs


def _rows_of(engine, sid):
    sess = engine._sessions[sid]
    if sess.bucket is None:
        return dict(sess.metric._state)
    return {k: v[sess.slot] for k, v in sess.bucket.stacked.items()}


def _equal_rows(name, got, want, exact=True):
    """Bit-equal states (exact) or the largest relative difference; fails on a mismatch of an exact state."""
    worst = 0.0
    for k, ref in want.items():
        a, b = got[k].detach().cpu(), ref.detach().cpu()
        if _bit_equal(a, b):
            continue
        if exact or not a.is_floating_point():
            fail(f"{name}: state {k!r} differs from its oracle")
        worst = max(worst, float(((a.double() - b.double()).abs() / b.double().abs().clamp(min=1e-30)).max()))
    return worst


def _counter(snap, name, exclude_compute=False):
    return int(sum(v for k, v in snap["counters"].get(name, {}).items()
                   if not (exclude_compute and k.endswith(":compute"))))


def fleet_streams(n_streams: int, seed: int, wrappers: dict, dev="cuda", oracle_every=FLEET_ORACLE_EVERY) -> dict:
    """(a) ``n_streams`` sessions, half MulticlassAccuracy(8 classes), half BinaryAUROC(16 thresholds), batch 16,
    3 ticks with 256 churned after the second, then polls: each tick's dispatches, kernel launches, host syncs
    and ms; polls' compute dispatches and ms; program builds through churn; sampled sessions against
    per-instance oracles on the card."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE

    on_card = torch.device(dev).type == "cuda"
    g = _host_generator(seed)
    half = n_streams // 2
    cap = 1 << (half - 1).bit_length()
    ctors = {"acc": lambda: MulticlassAccuracy(num_classes=8, validate_args=False, device=dev),
             "auroc": lambda: BinaryAUROC(thresholds=16, device=dev)}

    def batch(kind, n):
        if kind == "acc":
            return (torch.randint(0, 8, (n, FLEET_BATCH), generator=g).to(dev),
                    torch.randint(0, 8, (n, FLEET_BATCH), generator=g).to(dev))
        return (torch.rand((n, FLEET_BATCH), generator=g).to(dev),
                torch.randint(0, 2, (n, FLEET_BATCH), generator=g).to(dev))

    _FLEET_JIT_CACHE.clear()
    res = {"streams": n_streams, "capacity": cap, "ticks": []}
    with observe.scope(reset=True):
        engine = StreamEngine(initial_capacity=cap)
        kinds, oracles = {}, {}
        t0 = time.perf_counter()
        for kind in ("acc", "auroc"):
            for i in range(half):
                sid = engine.add_session(ctors[kind]())
                kinds[sid] = kind
                if i % oracle_every == 0:
                    oracles[sid] = ctors[kind]()
        res["add_s"] = time.perf_counter() - t0
        next_new = 0
        for t in range(FLEET_TICKS):
            live = {k: [s for s in kinds if kinds[s] == k] for k in ("acc", "auroc")}
            cols = {k: batch(k, len(v)) for k, v in live.items()}

            def submit_and_tick():
                for k, sids in live.items():
                    p, y = cols[k]
                    for i, sid in enumerate(sids):
                        engine.submit(sid, p[i], y[i])
                return engine.tick()

            dispatches, ms, launches, syncs = _watched(submit_and_tick, dev, wrappers)
            for k, sids in live.items():
                p, y = cols[k]
                for i, sid in enumerate(sids):
                    if sid in oracles:
                        oracles[sid].update(p[i], y[i])
            snap = observe.snapshot()
            polls = []
            for _ in range(2):
                _, poll_ms, _, poll_syncs = _watched(engine.compute_all, dev, wrappers)
                polls.append((poll_ms, poll_syncs))
            snap = observe.snapshot()
            res["ticks"].append({"dispatches": dispatches, "tick_ms": ms, "launches": launches, "syncs": syncs,
                                 "poll_ms": [p[0] for p in polls], "poll_syncs": [p[1] for p in polls],
                                 "update_programs": _counter(snap, "fleet_compile", True),
                                 "compute_dispatches": _counter(snap, "fleet_compute_dispatch")})
            if dispatches != 1:
                fail(f"fleet {n_streams}: tick {t} made {dispatches} dispatches, not 1")
            if on_card and (launches["binned_counts"] != 1 or launches["binned_counts_labels"]
                            or launches["ssim_window"]):
                fail(f"fleet {n_streams}: tick {t} launched {launches}; the AUROC bucket's one wave is one launch")
            if t == 1:  # churn: 128 sessions of each class retire (checked against their oracles when sampled),
                # 256 arrive into the recycled rows
                retire = live["acc"][: FLEET_CHURN // 2] + live["auroc"][: FLEET_CHURN // 2]
                for sid in retire:
                    m = engine.expire(sid)
                    if sid in oracles:
                        _equal_rows(f"fleet {n_streams} retired {sid}", m._state, oracles.pop(sid)._state)
                    del kinds[sid]
                for i in range(FLEET_CHURN):
                    kind = ("acc", "auroc")[i % 2]
                    sid = engine.add_session(ctors[kind](), session_id=f"new{next_new}")
                    next_new += 1
                    kinds[sid] = kind
                    if i % 8 == 0:
                        oracles[sid] = ctors[kind]()
        snap = observe.snapshot()
        res["update_programs"] = _counter(snap, "fleet_compile", True)
        res["fleet_dispatch"] = _counter(snap, "fleet_dispatch")
        res["compute_dispatches"] = _counter(snap, "fleet_compute_dispatch")
        res["loose_updates"] = _counter(snap, "fleet_loose_update")
        if res["update_programs"] != 1 or res["compute_dispatches"] or res["loose_updates"]:
            fail(f"fleet {n_streams}: {res['update_programs']} update programs, {res['compute_dispatches']} "
                 f"compute dispatches, {res['loose_updates']} loose updates (want 1, 0, 0)")
        values = engine.compute_all()
        for sid, oracle in oracles.items():
            _equal_rows(f"fleet {n_streams} session {sid}", _rows_of(engine, sid), oracle._state)
            if not torch.allclose(values[sid].double(), oracle.compute().cpu().double(), rtol=1e-6, atol=0):
                fail(f"fleet {n_streams} session {sid}: value {values[sid]} vs its oracle {oracle.compute()}")
        res["oracles_bit_equal"] = len(oracles)
    _FLEET_JIT_CACHE.clear()
    return res, engine, kinds




def fleet_ssim(seed: int, wrappers: dict, dev="cuda") -> dict:
    """(b) 512 SSIM monitors, each submitting one (1, 3, 256, 256) pair a tick: one window launch of the
    bucket's 512 x 15 = 7,680 planes a tick; sampled sessions against oracles on the card."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    g = _host_generator(seed + 1)
    _FLEET_JIT_CACHE.clear()
    res = {"sessions": SSIM_SESSIONS, "ticks": []}
    worst = 0.0
    with observe.scope(reset=True):
        engine = StreamEngine(initial_capacity=SSIM_SESSIONS)
        make = lambda: StructuralSimilarityIndexMeasure(data_range=1.0, device=dev)  # noqa: E731
        sids = [engine.add_session(make()) for _ in range(SSIM_SESSIONS)]
        oracles = {sid: make() for sid in sids[::64]}
        for _ in range(SSIM_FLEET_TICKS):
            a = torch.rand((SSIM_SESSIONS,) + SSIM_FLEET_SHAPE, generator=g).to(dev)
            b = (0.75 * a + 0.25 * torch.rand((SSIM_SESSIONS,) + SSIM_FLEET_SHAPE, generator=g).to(dev))

            def submit_and_tick():
                for i, sid in enumerate(sids):
                    engine.submit(sid, a[i], b[i])
                return engine.tick()

            dispatches, ms, launches, syncs = _watched(submit_and_tick, dev, wrappers)
            for i, sid in enumerate(sids):
                if sid in oracles:
                    oracles[sid].update(a[i], b[i])
            res["ticks"].append({"dispatches": dispatches, "tick_ms": ms, "launches": launches, "syncs": syncs})
            if dispatches != 1 or (torch.device(dev).type == "cuda" and launches["ssim_window"] != 1):
                fail(f"SSIM fleet: a tick made {dispatches} dispatches and {launches} launches (want 1 and 1 window)")
            del a, b
        _, poll_ms, _, poll_syncs = _watched(engine.compute_all, dev, wrappers)
        res.update(poll_ms=poll_ms, poll_syncs=poll_syncs)
        values = engine.compute_all()
        for sid, oracle in oracles.items():
            worst = max(worst, _equal_rows(f"SSIM fleet session {sid}", _rows_of(engine, sid), oracle._state,
                                           exact=False))
            if abs(float(values[sid]) - float(oracle.compute())) > 1e-6:
                fail(f"SSIM fleet session {sid}: {float(values[sid])} vs its oracle {float(oracle.compute())}")
        snap = observe.snapshot()
        res["update_programs"] = _counter(snap, "fleet_compile", True)
        res["loose_updates"] = _counter(snap, "fleet_loose_update")
    res["oracles"] = len(oracles)
    res["max_rel_diff_vs_oracles"] = worst
    _FLEET_JIT_CACHE.clear()
    return res


def fleet_multiclass_auroc(seed: int, wrappers: dict, dev="cuda") -> dict:
    """(c) 1,000 MulticlassAUROC(10 classes, 200 thresholds) sessions, batch 256: under vmap the labels mode
    becomes the plain mode's one-hot over (256, 1,024 x 10) columns, one binned-counts launch a tick."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.classification import MulticlassAUROC
    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE

    g = _host_generator(seed + 2)
    _FLEET_JIT_CACHE.clear()
    res = {"sessions": MCAUROC_SESSIONS, "ticks": []}
    with observe.scope(reset=True):
        engine = StreamEngine(initial_capacity=1024)
        make = lambda: MulticlassAUROC(num_classes=MCAUROC_CLASSES, thresholds=MCAUROC_THRESHOLDS,  # noqa: E731
                                       device=dev)
        sids = [engine.add_session(make()) for _ in range(MCAUROC_SESSIONS)]
        oracles = {sid: make() for sid in sids[::100]}
        for _ in range(MCAUROC_TICKS):
            p = torch.softmax(torch.randn((MCAUROC_SESSIONS, MCAUROC_BATCH, MCAUROC_CLASSES), generator=g), -1).to(dev)
            y = torch.randint(0, MCAUROC_CLASSES, (MCAUROC_SESSIONS, MCAUROC_BATCH), generator=g).to(dev)

            def submit_and_tick():
                for i, sid in enumerate(sids):
                    engine.submit(sid, p[i], y[i])
                return engine.tick()

            dispatches, ms, launches, syncs = _watched(submit_and_tick, dev, wrappers)
            for i, sid in enumerate(sids):
                if sid in oracles:
                    oracles[sid].update(p[i], y[i])
            res["ticks"].append({"dispatches": dispatches, "tick_ms": ms, "launches": launches, "syncs": syncs})
            if dispatches != 1 or (torch.device(dev).type == "cuda" and (launches["binned_counts"] != 1
                                                                         or launches["binned_counts_labels"])):
                fail(f"multiclass AUROC fleet: a tick made {dispatches} dispatches and launched {launches}")
        values = engine.compute_all()
        for sid, oracle in oracles.items():
            _equal_rows(f"multiclass AUROC fleet session {sid}", _rows_of(engine, sid), oracle._state)
            if abs(float(values[sid]) - float(oracle.compute())) > 1e-6:
                fail(f"multiclass AUROC session {sid}: {float(values[sid])} vs {float(oracle.compute())}")
        snap = observe.snapshot()
        res["update_programs"] = _counter(snap, "fleet_compile", True)
        res["loose_updates"] = _counter(snap, "fleet_loose_update")
    res["oracles_bit_equal"] = len(oracles)
    _FLEET_JIT_CACHE.clear()
    return res


def fleet_recovery(seed: int, dev="cuda") -> dict:
    """(d) the 1,000-stream fleet with a journal: 3 ticks, a checkpoint, a fourth wave submitted and journaled
    but never ticked (the crash), then a restore on the card and one on the CPU: both bit-exact against the
    fleet that did not crash."""
    import shutil
    import tempfile

    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
    from metrics_tpu_torch.engine import StreamEngine

    g = _host_generator(seed + 3)
    tmp = tempfile.mkdtemp(prefix="fleet_recovery_")
    try:
        wal, ckpt = os.path.join(tmp, "fleet.wal"), os.path.join(tmp, "fleet.mtckpt")
        engine = StreamEngine(initial_capacity=512, wal_path=wal)
        half = FLEET_SMALL // 2
        sids = ([engine.add_session(MulticlassAccuracy(num_classes=8, validate_args=False, device=dev))
                 for _ in range(half)] + [engine.add_session(BinaryAUROC(thresholds=16, device=dev))
                                          for _ in range(half)])

        def wave():
            acc = (torch.randint(0, 8, (half, FLEET_BATCH), generator=g).to(dev),
                   torch.randint(0, 8, (half, FLEET_BATCH), generator=g).to(dev))
            auroc = (torch.rand((half, FLEET_BATCH), generator=g).to(dev),
                     torch.randint(0, 2, (half, FLEET_BATCH), generator=g).to(dev))
            for i, sid in enumerate(sids):
                p, y = acc if i < half else auroc
                engine.submit(sid, p[i % half], y[i % half])

        for _ in range(3):
            wave()
            engine.tick()
        _, ckpt_ms = _wall(lambda: engine.checkpoint(ckpt), dev)
        wave()  # journaled and fsynced at the next flush boundary; the crash comes first
        engine._wal.sync()
        recovered, restore_ms = _wall(lambda: StreamEngine.restore(ckpt, wal_path=os.path.join(tmp, "fleet.wal")),
                                      dev)
        _, replay_tick_ms = _wall(recovered.tick, dev)
        engine.tick()  # the fleet that did not crash applies the same wave
        for sid in sids:
            _equal_rows(f"recovered session {sid}", _rows_of(recovered, sid), _rows_of(engine, sid))
        shutil.copy(wal, os.path.join(tmp, "cpu.wal"))
        on_cpu, cpu_restore_ms = _wall(lambda: StreamEngine.restore(ckpt, wal_path=os.path.join(tmp, "cpu.wal"),
                                                                   device="cpu"), dev)
        on_cpu.tick()
        for sid in sids:
            _equal_rows(f"session {sid} restored on the CPU", _rows_of(on_cpu, sid), _rows_of(engine, sid))
        return {"sessions": len(sids), "checkpoint_ms": ckpt_ms, "checkpoint_bytes": os.path.getsize(ckpt),
                "restore_ms": restore_ms, "replayed_tick_ms": replay_tick_ms, "cpu_restore_ms": cpu_restore_ms,
                "bit_exact_on_card": True, "equal_on_cpu": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fleet_sharded(seed: int, dev="cuda", sessions=SHARDED_SESSIONS) -> dict:
    """(e) 25,000 two-scalar stream means over 8 shards on one card (capacity 2^14 a shard), 2,048 sessions
    active a tick and 512 churned, 4 ticks: one dispatch per shard tick; then shard 0's dispatch dies and the
    shard heals from its own files, and the fleet restores into 12 shards; sampled sessions against oracles."""
    import shutil
    import tempfile

    from metrics_tpu_torch import observe
    from metrics_tpu_torch.engine import DispatchConsumedError, ShardedStreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE

    StreamMean = _stream_mean_class()
    g = _host_generator(seed + 4)
    rng = np.random.default_rng(seed + 4)
    tmp = tempfile.mkdtemp(prefix="fleet_sharded_")
    _FLEET_JIT_CACHE.clear()
    res = {"sessions": sessions, "shards": SHARDED_SHARDS, "ticks": []}
    try:
        with observe.scope(reset=True):
            fleet = ShardedStreamEngine(n_shards=SHARDED_SHARDS, initial_capacity=SHARDED_CAPACITY,
                                        wal_dir=os.path.join(tmp, "w"), devices=[dev])
            t0 = time.perf_counter()
            sids = [f"u{i}" for i in range(sessions)]
            oracles = {}
            for i, sid in enumerate(sids):
                fleet.add_session(StreamMean(device=dev), sid)
                if i % SHARDED_ORACLE_EVERY == 0:
                    oracles[sid] = StreamMean(device=dev)
            res["add_s"] = time.perf_counter() - t0
            live, next_id = list(sids), sessions
            for t in range(SHARDED_TICKS):
                active = [live[i] for i in rng.choice(len(live), SHARDED_ACTIVE, replace=False)]
                x = torch.rand((SHARDED_ACTIVE, FLEET_BATCH), generator=g).to(dev)

                def submit_and_tick():
                    for i, sid in enumerate(active):
                        fleet.submit(sid, x[i])
                    return fleet.tick()

                before = _counter(observe.snapshot(), "fleet_dispatch")
                dispatches, ms = _wall(submit_and_tick, dev)
                for i, sid in enumerate(active):
                    if sid in oracles:
                        oracles[sid].update(x[i])
                touched = len({fleet.shard_of(s) for s in active})
                res["ticks"].append({"dispatches": dispatches, "shards_touched": touched, "tick_ms": ms})
                if dispatches != touched or _counter(observe.snapshot(), "fleet_dispatch") - before != touched:
                    fail(f"sharded fleet: tick {t} made {dispatches} dispatches over {touched} shards")
                if t == 1:
                    doomed = set(live[i] for i in rng.choice(len(live), SHARDED_CHURN, replace=False))
                    for sid in doomed:
                        fleet.expire(sid)
                        oracles.pop(sid, None)
                    live = [s for s in live if s not in doomed]
                    for _ in range(SHARDED_CHURN):
                        sid = f"u{next_id}"
                        next_id += 1
                        fleet.add_session(StreamMean(device=dev), sid)
                        live.append(sid)
            snap = observe.snapshot()
            res["update_programs"] = _counter(snap, "fleet_compile", True)
            res["loose_updates"] = _counter(snap, "fleet_loose_update")
            _, res["checkpoint_ms"] = _wall(lambda: fleet.checkpoint(os.path.join(tmp, "c")), dev)
            want = {sid: oracle.compute() for sid, oracle in oracles.items()}

            def check(name, fl):
                for sid, value in want.items():
                    got = fl.compute(sid)
                    _equal_rows(f"{name} session {sid}", {"v": got.reshape(())}, {"v": value.cpu().reshape(())})

            check("sharded fleet", fleet)
            # shard 0's next dispatch dies: the shard heals from its own checkpoint file and journal
            shard0 = [s for s in live if fleet.shard_of(s) == 0][:64]
            x = torch.rand((len(shard0), FLEET_BATCH), generator=g).to(dev)
            for i, sid in enumerate(shard0):
                fleet.submit(sid, x[i])
                if sid in oracles:
                    oracles[sid].update(x[i])
            want = {sid: oracle.compute() for sid, oracle in oracles.items()}

            def dead(staged):
                raise DispatchConsumedError("injected: shard 0's dispatch died")

            fleet._shards[0]._dispatch_flush = dead
            _, res["one_shard_heal_tick_ms"] = _wall(fleet.tick, dev)
            if not fleet._heal_suspect == {0}:
                fail("sharded fleet: shard 0 did not heal")
            check("healed fleet", fleet)
            fleet.checkpoint(os.path.join(tmp, "c"))
            for shard in fleet._shards:
                if shard._wal is not None:
                    shard._wal.close()
            grown, res["resize_8_to_12_ms"] = _wall(lambda: ShardedStreamEngine.restore(
                os.path.join(tmp, "c"), wal_dir=os.path.join(tmp, "w"), n_shards=12, devices=[dev]), dev)
            if grown.n_shards != 12 or len(grown) != len(live):
                fail(f"sharded fleet: the resize gave {grown.n_shards} shards and {len(grown)} sessions")
            check("resized fleet", grown)
            res["oracles_bit_equal"] = len(want)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _FLEET_JIT_CACHE.clear()
    return res


def fleet_bootstrap(imagenet_gpu, seed: int, wrappers: dict) -> dict:
    """(f) BootStrapper(MulticlassAccuracy, 20 copies) over the ImageNet-1k inputs through the replica engine
    (one gather-mode dispatch an update) and through its loop, from one seed: equal states, and each path's
    update ms."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.wrappers import BootStrapper
    from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper

    def run(engine: bool):
        np.random.seed(seed)
        boot = BootStrapper(MulticlassAccuracy(num_classes=IN_CLASSES, average="micro", device="cuda"),
                            num_bootstraps=BOOT_COPIES, raw=True)
        if not engine:
            boot._engine_ok = lambda args, kwargs: False
        with observe.scope(reset=True):
            ms = [_timed(lambda: boot.update(p, t))[1] for p, t in imagenet_gpu]
            out, compute_ms = _timed(boot.compute)
            dispatches = _counter(observe.snapshot(), "replica_dispatch")
        return boot, out, ms, compute_ms, dispatches

    eng, out_e, ms_e, cms_e, disp_e = run(True)
    loop, out_l, ms_l, cms_l, disp_l = run(False)
    if disp_e != len(imagenet_gpu) + 1 or disp_l:
        fail(f"BootStrapper: {disp_e} replica dispatches on the engine, {disp_l} in the loop")
    for a, b in zip(eng.metrics, loop.metrics):
        _equal_rows("BootStrapper copy", a._state, b._state)
    if not torch.equal(out_e["raw"], out_l["raw"]):
        fail("BootStrapper: the engine's copies computed other scores than the loop's")
    return {"copies": BOOT_COPIES, "updates": len(imagenet_gpu), "engine_update_ms_median": _median_ms(ms_e),
            "loop_update_ms_median": _median_ms(ms_l), "engine_compute_ms": cms_e, "loop_compute_ms": cms_l,
            "replica_dispatches": disp_e}


def fleet_engine(seed: int, wrappers: dict, imagenet_gpu) -> dict:
    """The fleet engine on the card, its launches counted apart from the main path's: (a) 10,000 and 1,000
    streams (launches and host syncs per tick equal at both sizes; the 1,000-stream fleet's states equal the
    port's CPU run), (b) 512 SSIM monitors, (c) 1,000 multiclass AUROC sessions, (d) recovery, (e) the
    25,000-session sharded fleet, (f) BootStrapper through the replica engine."""
    res = {}
    t0 = time.perf_counter()
    res["streams_10000"], _, _ = fleet_streams(FLEET_STREAMS, seed, wrappers)
    res["streams_1000"], small, kinds = fleet_streams(FLEET_SMALL, seed + 7, wrappers)
    big, little = res["streams_10000"]["ticks"], res["streams_1000"]["ticks"]
    for t, (a, b) in enumerate(zip(big, little)):
        if a["launches"] != b["launches"] or a["syncs"] != b["syncs"]:
            fail(f"fleet tick {t}: 10,000 streams launched {a['launches']} with {a['syncs']} host syncs, 1,000 "
                 f"streams {b['launches']} with {b['syncs']}")
    _, cpu, _ = fleet_streams(FLEET_SMALL, seed + 7, wrappers, dev="cpu", oracle_every=FLEET_SMALL)
    subset = [s for s in kinds if kinds[s] == "acc"][:FLEET_CPU_SUBSET] + \
        [s for s in kinds if kinds[s] == "auroc"][:FLEET_CPU_SUBSET]
    for sid in subset:
        _equal_rows(f"fleet session {sid} on the CPU", _rows_of(cpu, sid), _rows_of(small, sid))
    res["cpu_subset_equal"] = len(subset)
    res["ssim_512"] = fleet_ssim(seed, wrappers)
    res["multiclass_auroc_1000"] = fleet_multiclass_auroc(seed, wrappers)
    res["recovery_1000"] = fleet_recovery(seed)
    res["sharded_25000"] = fleet_sharded(seed)
    res["bootstrap_imagenet"] = fleet_bootstrap(imagenet_gpu, seed, wrappers)
    ticks = [t for key in ("streams_10000", "streams_1000", "ssim_512", "multiclass_auroc_1000") for t in res[key]["ticks"]]
    res["launches"] = {k: sum(t["launches"][k] for t in ticks) for k in wrappers}
    res["seconds"] = time.perf_counter() - t0
    log(f"fleet_engine: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------------------- phase 4, the front door
# served fleets at the fleet_engine section's sizes (a): two producer processes, 5,000 + 5,000 or 500 + 500
# streams, batch 16, 3 ticks; (b) a child server on the card killed mid-stream; (c) the JAX package's soak
# (bench.py:81-87, :1370): 96 sessions, 3 warm-up + 10 steady ticks, 30 overload arrivals; (d) 8 shards
SERVE_KEY = "chip-smoke-key"
SERVE_CRASH_SESSIONS, SERVE_CRASH_WAVES = 1_000, 4
SOAK_SESSIONS, SOAK_CAPACITY, SOAK_STEADY, SOAK_WARMUP, SOAK_ARRIVALS = 96, 128, 10, 3, 30
SERVE_SHARDS, SERVE_SHARD_SESSIONS, SERVE_SHARD_SKEW = 8, 2_000, 1_600
SERVE_ORACLE_EVERY = 50

# one producer process: arrives ``n`` sessions of one class (port metrics on the CPU: only host bytes travel),
# then on each "go" line submits one numpy batch to every session and reports the wave's ack latencies
_PRODUCER_CHILD = r"""
import json, sys, time
import numpy as np
from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
from metrics_tpu_torch.serve.protocol import Producer

host, port, key, kind, n, ticks, batch, seed = sys.argv[1:9]
port, n, ticks, batch, seed = int(port), int(n), int(ticks), int(batch), int(seed)


class TimedProducer(Producer):
    # send time of each pseq (when pump first puts it on the wire) and its ack latency
    def __init__(self, *a, **k):
        self.sent, self.lat = {}, []
        super().__init__(*a, **k)

    def pump(self):
        before = set(self._inflight)
        super().pump()
        now = time.perf_counter()
        for p in self._inflight - before:
            self.sent.setdefault(p, now)

    def _handle(self, rec):
        if rec[0] == "ack" and int(rec[1]) in self.sent:
            self.lat.append(time.perf_counter() - self.sent.pop(int(rec[1])))
        super()._handle(rec)


prod = TimedProducer((host, port), key, name=f"producer-{kind}", timeout=600.0)
make = (lambda: MulticlassAccuracy(num_classes=8, validate_args=False, device="cpu")) if kind == "acc" else (
    lambda: BinaryAUROC(thresholds=16, device="cpu"))
for i in range(n):
    prod.add_session(make(), session_id=f"{kind}{i}")
prod.flush(600.0)
print(json.dumps({"added": n, "errors": prod.errors[:3]}), flush=True)
for t in range(ticks):
    if sys.stdin.readline().strip() != "go":
        sys.exit(2)
    rng = np.random.default_rng([seed, 0 if kind == "acc" else 1, t])
    if kind == "acc":
        a, b = rng.integers(0, 8, (n, batch)), rng.integers(0, 8, (n, batch))
    else:
        a, b = rng.random((n, batch), dtype=np.float32), rng.integers(0, 2, (n, batch))
    prod.lat = []
    for i in range(n):
        prod.submit(f"{kind}{i}", a[i], b[i])
    prod.flush(600.0)
    print(json.dumps({"tick": t, "lat": prod.lat, "errors": prod.errors[:3]}), flush=True)
prod.close()
"""

# the crash leg's server: a fresh interpreter on the card, journaling to argv[1], polling and ticking until killed
_SERVER_CHILD = r"""
import sys
from metrics_tpu_torch.engine.stream import StreamEngine
from metrics_tpu_torch.serve.server import MetricsServer

engine = StreamEngine(initial_capacity=1024, wal_path=sys.argv[1])
server = MetricsServer(engine, sys.argv[2], host="127.0.0.1", device=sys.argv[3])
print(server.address[1], flush=True)
n = 0
while True:
    server.poll(0.02)
    n += 1
    if n % 8 == 0:
        engine.tick()
"""


def _serve_batch(seed: int, kind: str, t: int, n: int):
    """The numpy batch a producer of ``kind`` submits at tick ``t`` (the same draws as _PRODUCER_CHILD's)."""
    rng = np.random.default_rng([seed, 0 if kind == "acc" else 1, t])
    if kind == "acc":
        return rng.integers(0, 8, (n, FLEET_BATCH)), rng.integers(0, 8, (n, FLEET_BATCH))
    return rng.random((n, FLEET_BATCH), dtype=np.float32), rng.integers(0, 2, (n, FLEET_BATCH))


def _spawn(code: str, *args) -> subprocess.Popen:
    """A fresh interpreter running ``code`` from the repository root (never a fork of this CUDA process)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root, env=env)


def _line_reader(proc, box: list):
    import threading

    def run():
        for line in proc.stdout:
            box.append(line)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _quantile_ms(values, q) -> float:
    return 1000 * float(np.quantile(np.asarray(values), q)) if values else float("nan")


def _served_capacity(sessions: int) -> int:
    """The smallest power of two that keeps a served bucket under 85 % full: the default admission table defers
    arrivals from 90 % (5,000 sessions get the fleet_engine section's 8,192 rows, 61 % full; 500 get 1,024)."""
    return 1 << (math.ceil(sessions / 0.85) - 1).bit_length()


def serve_streams(n_streams: int, seed: int, wrappers: dict, dev="cuda") -> dict:
    """(a) ``n_streams`` served streams: a StreamEngine on ``dev`` with its journal in a temporary directory, a
    MetricsServer on 127.0.0.1, and two producer processes (half MulticlassAccuracy(8), half BinaryAUROC(16
    thresholds)), batch 16 (numpy), 3 ticks. Each tick: the wave's frames a second, ack latency p50/p99 (send
    to ack), fsyncs a poll batch, then the tick's ms, dispatches, launches and host syncs; sampled sessions
    bit-equal to per-instance oracles on ``dev``."""
    import shutil
    import tempfile

    from metrics_tpu_torch import observe
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.serve.server import MetricsServer

    half = n_streams // 2
    cap = _served_capacity(half)
    tmp = tempfile.mkdtemp(prefix="serve_streams_")
    _FLEET_JIT_CACHE.clear()
    procs, res = [], {"streams": n_streams, "capacity": cap, "ticks": []}
    try:
        with observe.scope(reset=True):
            engine = StreamEngine(initial_capacity=cap, wal_path=os.path.join(tmp, "serve.wal"))
            server = MetricsServer(engine, SERVE_KEY, host="127.0.0.1", device=dev)
            fsyncs = [0]
            real_sync = engine._wal.sync

            def counted_sync():
                fsyncs[0] += 1
                real_sync()

            engine._wal.sync = counted_sync
            lines = {}
            for kind in ("acc", "auroc"):
                p = _spawn(_PRODUCER_CHILD, "127.0.0.1", server.address[1], SERVE_KEY, kind, half, FLEET_TICKS,
                           FLEET_BATCH, seed)
                procs.append(p)
                lines[kind] = []
                _line_reader(p, lines[kind])

            polls = {"batches": 0, "fsyncs": 0}

            def pump_until(n_lines: int, timeout: float):
                deadline = time.perf_counter() + timeout
                while any(len(v) < n_lines for v in lines.values()):
                    before = fsyncs[0]
                    if server.poll(0.002):
                        polls["batches"] += 1
                        polls["fsyncs"] += fsyncs[0] - before
                    if time.perf_counter() > deadline or any(p.poll() is not None for p in procs):
                        errs = [p.stderr.read()[-2000:] for p in procs if p.poll() is not None]
                        fail(f"served fleet {n_streams}: producers stalled or died: {errs}")

            t0 = time.perf_counter()
            pump_until(1, 900.0)
            res["add_s"] = time.perf_counter() - t0
            for kind in lines:
                if json.loads(lines[kind][0])["errors"]:
                    fail(f"served fleet {n_streams}: {kind} arrivals errored: {lines[kind][0]}")
            if len(engine) != 2 * half:
                fail(f"served fleet {n_streams}: the engine holds {len(engine)} sessions")
            sids = {"acc": [f"acc{i}" for i in range(half)], "auroc": [f"auroc{i}" for i in range(half)]}
            ctors = {"acc": lambda: MulticlassAccuracy(num_classes=8, validate_args=False, device=dev),
                     "auroc": lambda: BinaryAUROC(thresholds=16, device=dev)}
            oracles = {(k, i): ctors[k]() for k in sids for i in range(0, half, SERVE_ORACLE_EVERY)}
            for t in range(FLEET_TICKS):
                frames0, polls["batches"], polls["fsyncs"] = server.frames_total, 0, 0
                t_wave = time.perf_counter()
                for p in procs:
                    p.stdin.write("go\n")
                    p.stdin.flush()
                pump_until(t + 2, 900.0)
                wave_s = time.perf_counter() - t_wave
                reports = {k: json.loads(lines[k][t + 1]) for k in lines}
                if any(r["errors"] for r in reports.values()):
                    fail(f"served fleet {n_streams}: tick {t} records errored: {reports}")
                lat = [x for r in reports.values() for x in r["lat"]]
                dispatches, ms, launches, syncs = _watched(engine.tick, dev, wrappers)
                res["ticks"].append({
                    "frames_per_s": (server.frames_total - frames0) / wave_s, "wave_s": wave_s,
                    "ack_ms_p50": _quantile_ms(lat, 0.5), "ack_ms_p99": _quantile_ms(lat, 0.99), "acks": len(lat),
                    "fsyncs_per_poll_batch": polls["fsyncs"] / max(1, polls["batches"]),
                    "poll_batches": polls["batches"],
                    "tick_ms": ms, "dispatches": dispatches, "launches": launches, "syncs": syncs})
                if dispatches != 1:
                    fail(f"served fleet {n_streams}: tick {t} made {dispatches} dispatches, not 1")
                if polls["fsyncs"] != polls["batches"]:
                    fail(f"served fleet {n_streams}: {polls['fsyncs']} fsyncs over {polls['batches']} poll batches")
                if torch.device(dev).type == "cuda" and (launches["binned_counts"] != 1 or
                                                         launches["binned_counts_labels"] or launches["ssim_window"]):
                    fail(f"served fleet {n_streams}: tick {t} launched {launches}; the AUROC bucket's wave is one")
                for (kind, i), oracle in oracles.items():
                    a, b = _serve_batch(seed, kind, t, half)
                    oracle.update(torch.from_numpy(a[i]).to(dev), torch.from_numpy(b[i]).to(dev))
            for (kind, i), oracle in oracles.items():
                _equal_rows(f"served fleet {n_streams} session {kind}{i}", _rows_of(engine, f"{kind}{i}"),
                            oracle._state)
            res["oracles_bit_equal"] = len(oracles)
            snap = observe.snapshot()
            res["update_programs"] = _counter(snap, "fleet_compile", True)
            res["loose_updates"] = _counter(snap, "fleet_loose_update")
            res["frames_total"] = server.frames_total
            res["bytes_in_total"] = server.bytes_in_total
            for p in procs:
                p.wait(120)
                if p.returncode:
                    fail(f"served fleet {n_streams}: a producer exited {p.returncode}: {p.stderr.read()[-2000:]}")
            server.close()
            engine._wal.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
        _FLEET_JIT_CACHE.clear()
    return res


def serve_crash(seed: int, dev="cuda") -> dict:
    """(b) ``kill -9`` of a child server process on the card mid-stream over TCP: 1,000 sessions, 4 waves, the
    child killed after the third wave's first ack; a restart from the surviving journal, a reconnect and a
    resend. Every acked record is applied exactly once (the resent ones acked ``dup``), and every session's
    state is bit-equal to an oracle engine fed each unique record once."""
    import shutil
    import signal
    import socket
    import tempfile

    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
    from metrics_tpu_torch.engine import IngestWAL, StreamEngine, replay_wal
    from metrics_tpu_torch.serve.protocol import Producer
    from metrics_tpu_torch.serve.server import MetricsServer

    half = SERVE_CRASH_SESSIONS // 2
    tmp = tempfile.mkdtemp(prefix="serve_crash_")
    wal = os.path.join(tmp, "serve.wal")
    child = _spawn(_SERVER_CHILD, wal, SERVE_KEY, dev)
    ctors = {"acc": lambda d: MulticlassAccuracy(num_classes=8, validate_args=False, device=d),
             "auroc": lambda d: BinaryAUROC(thresholds=16, device=d)}
    res = {"sessions": SERVE_CRASH_SESSIONS, "waves": SERVE_CRASH_WAVES}
    server2 = None
    try:
        line = child.stdout.readline()
        if not line.strip().isdigit():
            fail(f"serve crash: the child server did not start: {child.stderr.read()[-2000:]}")
        prod = Producer(("127.0.0.1", int(line)), SERVE_KEY, name="crash-producer", timeout=300.0)
        sids = [(k, f"{k}{i}") for k in ("acc", "auroc") for i in range(half)]
        for kind, sid in sids:
            prod.add_session(ctors[kind]("cpu"), session_id=sid)

        def wave(t):
            cols = {k: _serve_batch(seed + 50, k, t, half) for k in ("acc", "auroc")}
            return [prod.submit(sid, cols[k][0][j % half], cols[k][1][j % half]) for j, (k, sid) in enumerate(sids)]

        for t in range(2):
            wave(t)
        prod.flush(300.0)
        acked_before = prod.acked
        wave(2)
        deadline = time.perf_counter() + 300.0
        while prod.acked < acked_before + 1:
            prod.pump()
            if time.perf_counter() > deadline:
                fail("serve crash: no ack of the third wave before the deadline")
            time.sleep(0.001)
        acked_at_kill, outstanding_at_kill = prod.acked, prod.outstanding
        t_kill = time.perf_counter()
        os.kill(child.pid, signal.SIGKILL)
        child.wait(60)
        res.update(acked_at_kill=acked_at_kill, unacked_at_kill=outstanding_at_kill)

        def restart():
            # the journal-only restart: a fresh engine, the journal replayed onto the card, reopened for appends
            eng = StreamEngine(initial_capacity=1024)
            replay_wal(eng, wal, device=dev)
            eng._wal, eng._wal_path = IngestWAL(wal), wal
            return eng

        recovered, res["replay_ms"] = _wall(restart, dev)
        if recovered.serve_watermark("crash-producer") < acked_at_kill:
            fail(f"serve crash: the journal's watermark {recovered.serve_watermark('crash-producer')} is below "
                 f"the last ack {acked_at_kill}: an acked record was lost")
        server2 = MetricsServer(recovered, SERVE_KEY, host="127.0.0.1", device=dev)
        prod._drive = lambda: server2.poll(0.0)
        prod.reconnect(socket.create_connection(server2.address))
        prod.flush(300.0)
        recovered.tick()
        res["recovery_s"] = time.perf_counter() - t_kill
        last = wave(3)
        prod.flush(300.0)
        recovered.tick()
        if prod.outstanding or prod.errors:
            fail(f"serve crash: {prod.outstanding} unacked, errors {prod.errors[:3]}")
        if recovered.serve_watermark("crash-producer") != max(last):
            fail("serve crash: the recovered watermark is not the last pseq")
        res["dup_acks"] = server2.dedup_skipped
        # the oracle: each unique record once, through a never-crashed engine on the same device
        oracle = StreamEngine(initial_capacity=1024)
        for kind, sid in sids:
            oracle.add_session(ctors[kind](dev), session_id=sid)
        for t in range(SERVE_CRASH_WAVES):
            cols = {k: _serve_batch(seed + 50, k, t, half) for k in ("acc", "auroc")}
            for j, (k, sid) in enumerate(sids):
                oracle.submit(sid, cols[k][0][j % half], cols[k][1][j % half])
            oracle.tick()
        for _kind, sid in sids:
            _equal_rows(f"serve crash session {sid}", _rows_of(recovered, sid), _rows_of(oracle, sid))
        res["bit_exact_sessions"] = len(sids)
        prod.close()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)
        if server2 is not None:
            server2.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def serve_overload(seed: int, dev="cuda") -> dict:
    """(c) the JAX package's serve soak (bench.py:1370) on the card: 96 sessions over loopback TCP, an abrupt
    producer disconnect and resend, 3 warm-up and 10 steady ticks (two hot sessions breach their quota), a
    poison record, then a forced overload that must trip all three reflexes (double, demote, shed loose
    sessions first), and a recovery; every surviving session bit-equal to a never-shed oracle on the card."""
    import shutil
    import tempfile

    from metrics_tpu_torch import observe
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.observe.metering import MeterPolicy
    from metrics_tpu_torch.serve.admission import DEFAULT_ADMISSION_TABLE, AdmissionController, AdmissionRule
    from metrics_tpu_torch.serve.autonomic import AutonomicController
    from metrics_tpu_torch.serve.protocol import Producer
    from metrics_tpu_torch.serve.server import MetricsServer

    rng = np.random.default_rng(seed + 23)
    ctor = lambda d=dev: MulticlassAccuracy(num_classes=8, validate_args=False, device=d)  # noqa: E731
    pool = [(rng.integers(0, 8, FLEET_BATCH), rng.integers(0, 8, FLEET_BATCH)) for _ in range(16)]
    pool_dev = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for a, b in pool]
    _FLEET_JIT_CACHE.clear()
    tmp = tempfile.mkdtemp(prefix="serve_overload_")
    try:
        with observe.scope(reset=True):
            observe.install_watchdog(min_interval_s=0.0)
            observe.install_meter(top_k=256, policy=MeterPolicy(max_updates=SOAK_STEADY * 3, action="demote"),
                                  poll_interval_s=3600.0)
            engine = StreamEngine(initial_capacity=SOAK_CAPACITY, wal_path=os.path.join(tmp, "serve.wal"))
            autonomic = AutonomicController(engine, min_interval_s={"double": 0.0, "demote": 0.0, "resize": 0.0,
                                                                    "shed": 0.0})
            server = MetricsServer(engine, SERVE_KEY, host="127.0.0.1", autonomic=autonomic, device=dev)
            drive = lambda _t=None: server.poll(0.0)  # noqa: E731
            prod = Producer(server.address, SERVE_KEY, name="soak-a", drive=drive)
            flaky = Producer(server.address, SERVE_KEY, name="soak-b", drive=drive)
            oracles = {}
            for i in range(SOAK_SESSIONS):
                prod.add_session(ctor("cpu"), session_id=f"s{i}")
                oracles[f"s{i}"] = ctor()
            prod.flush(60.0)
            flaky.add_session(ctor("cpu"), session_id="flaky-s")
            flaky.flush(60.0)
            for _ in range(4):
                flaky.submit("flaky-s", *pool[0])
            flaky.pump()
            server.poll(0.0)
            flaky._sock.close()  # the abrupt disconnect: acks lost, the reconnect resends everything unacked
            flaky.reconnect()
            flaky.flush(60.0)
            oracles["flaky-s"] = ctor()
            for _ in range(4):
                oracles["flaky-s"].update(*pool_dev[0])
            hot = ["s0", "s1"]
            tick_ms, dispatches_steady, compiles_at_steady = [], 0, None
            for t in range(SOAK_WARMUP + SOAK_STEADY):
                for i, sid in enumerate(list(oracles)):
                    for _ in range(3 if sid in hot else 1):
                        prod.submit(sid, *pool[(i + t) % 16])
                        oracles[sid].update(*pool_dev[(i + t) % 16])
                prod.flush(60.0)
                d, ms = _wall(server.tick, dev)
                tick_ms.append(ms)
                if t == SOAK_WARMUP - 1:
                    compiles_at_steady = _counter(observe.snapshot(), "fleet_compile", True)
                    dispatch0 = _counter(observe.snapshot(), "fleet_dispatch")
            steady_recompiles = _counter(observe.snapshot(), "fleet_compile", True) - compiles_at_steady
            dispatches_steady = _counter(observe.snapshot(), "fleet_dispatch") - dispatch0
            poison = prod.submit("no-such-session", *pool[0])
            prod.flush(60.0)
            poison_errs = [e for e in prod.errors if e[0] >= poison]
            server.tick()
            server.admission = AdmissionController(
                (AdmissionRule("forced_overload", "occupancy_pct", ">=", 0.0, "shed", None),))
            for i in range(SOAK_ARRIVALS):
                prod.add_session(ctor("cpu"), session_id=f"burst{i}")
                oracles[f"burst{i}"] = ctor()
            prod.flush(60.0)
            mt = observe.installed_meter()
            deadline, extra = time.perf_counter() + 60.0, 0
            while min(autonomic.counts[a] for a in ("double", "demote", "shed")) < 1 and \
                    time.perf_counter() < deadline:
                prod.add_session(ctor("cpu"), session_id=f"extra{extra}")
                oracles[f"extra{extra}"] = ctor()
                extra += 1
                for sid in hot:
                    if sid in engine._sessions:
                        prod.submit(sid, *pool[0])
                        oracles[sid].update(*pool_dev[0])
                prod.flush(60.0)
                mt._last_poll = float("-inf")  # the autonomic step of the next tick's poll sees the quota breach
                server.tick()
            reflexes = dict(autonomic.counts)
            server.admission = AdmissionController(DEFAULT_ADMISSION_TABLE)
            for t in range(3):
                for i, sid in enumerate(list(engine._sessions)):
                    if sid in oracles:
                        prod.submit(sid, *pool[(i + t) % 16])
                        oracles[sid].update(*pool_dev[(i + t) % 16])
                prod.flush(60.0)
                server.tick()
            health = observe.installed_watchdog().health()
            survivors = 0
            for sid in list(engine._sessions):
                if sid in oracles:
                    survivors += 1
                    _equal_rows(f"soak survivor {sid}", _rows_of(engine, sid), oracles[sid]._state)
            snap = observe.snapshot()
            admission = dict(snap["counters"].get("serve_admission", {}))
            stats = server.stats()
            prod.close()
            flaky.close()
            server.close()
            engine._wal.close()
            observe.uninstall_meter()
            observe.uninstall_watchdog()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _FLEET_JIT_CACHE.clear()
    if min(reflexes[a] for a in ("double", "demote", "shed")) < 1:
        fail(f"serve overload: the reflexes fired {reflexes}; double, demote and shed must each fire")
    if not poison_errs:
        fail("serve overload: the poison record got no err ack")
    if steady_recompiles or dispatches_steady != SOAK_STEADY:
        fail(f"serve overload: {steady_recompiles} steady recompiles, {dispatches_steady} dispatches over "
             f"{SOAK_STEADY} steady ticks")
    steady = sorted(tick_ms[SOAK_WARMUP:])
    return {"sessions": SOAK_SESSIONS + 1, "overload_arrivals": SOAK_ARRIVALS + extra, "survivors_bit_exact": survivors,
            "reflexes": reflexes, "admission": admission, "dedup_skipped": stats["dedup_skipped"],
            "poison_err_acks": len(poison_errs), "steady_recompiles": steady_recompiles,
            "dispatches_per_steady_tick": dispatches_steady / SOAK_STEADY,
            "steady_tick_ms_p50": float(np.median(steady)), "steady_tick_ms_max": steady[-1],
            "watchdog_firing": health["firing"]}


def serve_sharded(seed: int, dev="cuda") -> dict:
    """(d) a ShardedStreamEngine of 8 shards on the card behind the server: each session on its hash's shard,
    each shard's watermark the last pseq routed to it, then arrivals skewed onto shard 0 until the autonomic
    controller resizes the fleet (8 -> 9) on the imbalance; every session's state survives the resize."""
    import shutil
    import tempfile

    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.engine import ShardedStreamEngine
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.engine.sharded import shard_of
    from metrics_tpu_torch.serve.autonomic import AutonomicController
    from metrics_tpu_torch.serve.protocol import Producer
    from metrics_tpu_torch.serve.server import MetricsServer

    rng = np.random.default_rng(seed + 31)
    tmp = tempfile.mkdtemp(prefix="serve_sharded_")
    _FLEET_JIT_CACHE.clear()
    res = {"shards": SERVE_SHARDS, "sessions": SERVE_SHARD_SESSIONS}
    try:
        fleet = ShardedStreamEngine(n_shards=SERVE_SHARDS, initial_capacity=4096, wal_dir=os.path.join(tmp, "w"),
                                    devices=[dev])
        auto = AutonomicController(fleet, occupancy_high_pct=101.0, shed_occupancy_pct=101.0, imbalance_ratio=4.0)
        server = MetricsServer(fleet, SERVE_KEY, host="127.0.0.1")
        prod = Producer(server.address, SERVE_KEY, name="shard-producer", drive=lambda: server.poll(0.0),
                        timeout=300.0)
        make = lambda: MulticlassAccuracy(num_classes=8, validate_args=False, device="cpu")  # noqa: E731
        last_pseq = {}
        sids = [f"d{i}" for i in range(SERVE_SHARD_SESSIONS)]
        for sid in sids:
            last_pseq[shard_of(sid, SERVE_SHARDS)] = prod.add_session(make(), session_id=sid)
        for _ in range(2):
            a, b = rng.integers(0, 8, (len(sids), FLEET_BATCH)), rng.integers(0, 8, (len(sids), FLEET_BATCH))
            for i, sid in enumerate(sids):
                last_pseq[shard_of(sid, SERVE_SHARDS)] = prod.submit(sid, a[i], b[i])
            prod.flush(300.0)
            dispatches, ms = _wall(fleet.tick, dev)
            res.setdefault("tick_ms", []).append(ms)
            if dispatches != SERVE_SHARDS:
                fail(f"served shards: a tick made {dispatches} dispatches over {SERVE_SHARDS} shards")
        for sid in sids:
            k = shard_of(sid, SERVE_SHARDS)
            if sid not in fleet._shards[k]._sessions:
                fail(f"served shards: {sid} is not on shard {k}")
        marks = [fleet._shards[k].serve_watermark("shard-producer") for k in range(SERVE_SHARDS)]
        if marks != [last_pseq[k] for k in range(SERVE_SHARDS)]:
            fail(f"served shards: watermarks {marks}, last pseqs routed {last_pseq}")
        res["watermarks"] = marks
        def rows(sid):
            return _rows_of(fleet._shards[fleet.shard_of(sid)], sid)

        before = {sid: {k: v.clone() for k, v in rows(sid).items()} for sid in sids[::97]}
        skew, i = [], 0
        while len(skew) < SERVE_SHARD_SKEW:
            sid = f"z{i}"
            i += 1
            if shard_of(sid, SERVE_SHARDS) == 0:
                skew.append(sid)
        for sid in skew:
            prod.add_session(make(), session_id=sid)
        prod.flush(300.0)
        counts = [len(s) for s in fleet._shards]
        actions, res["resize_ms"] = _wall(auto.step, dev)
        if [a.action for a in actions] != ["resize"] or fleet.n_shards != SERVE_SHARDS + 1:
            fail(f"served shards: shard populations {counts} gave actions {actions}, {fleet.n_shards} shards")
        if len(fleet) != len(sids) + len(skew):
            fail(f"served shards: {len(fleet)} sessions after the resize")
        for sid, want in before.items():
            _equal_rows(f"served shards session {sid} after the resize", rows(sid), want)
        a, b = rng.integers(0, 8, (len(sids), FLEET_BATCH)), rng.integers(0, 8, (len(sids), FLEET_BATCH))
        for i, sid in enumerate(sids):
            prod.submit(sid, a[i], b[i])
        prod.flush(300.0)
        dispatches = fleet.tick()
        if prod.errors or dispatches != fleet.n_shards:
            fail(f"served shards: after the resize {dispatches} dispatches, errors {prod.errors[:3]}")
        res.update(populations_before_resize=counts, shards_after=fleet.n_shards, sessions_after=len(fleet))
        prod.close()
        server.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _FLEET_JIT_CACHE.clear()
    return res


def serve_refusals(dev="cuda") -> dict:
    """(e) a frame that pickles a torch tensor reads as damage and drops only its connection; a metric blob
    naming a class of the JAX package gets an ``err`` ack with the reason; the reactor serves on."""
    import pickle
    import socket
    import struct
    import zlib

    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.serve.protocol import WAL_MAGIC, Producer
    from metrics_tpu_torch.serve.server import MetricsServer

    engine = StreamEngine()
    server = MetricsServer(engine, SERVE_KEY, host="127.0.0.1", device=dev)
    prod = Producer(server.address, SERVE_KEY, name="honest", drive=lambda: server.poll(0.0))
    body = pickle.dumps(("submit", 1, "s0", ((torch.arange(4),), {})), protocol=pickle.HIGHEST_PROTOCOL)
    evil = socket.create_connection(server.address)
    evil.sendall(WAL_MAGIC + struct.pack(">II", len(body), zlib.crc32(body) & 0xFFFFFFFF) + body)
    deadline = time.perf_counter() + 30
    while server.protocol_errors < 1 and time.perf_counter() < deadline:
        server.poll(0.01)
    if server.protocol_errors != 1 or server.disconnects != 1:
        fail(f"serve refusals: the torch-global frame gave {server.protocol_errors} protocol errors and "
             f"{server.disconnects} disconnects")
    # a JAX-package metric as its pickle names it (this machine has no JAX): the server must refuse the class
    # before importing anything
    jax_blob = b"\x80\x02cmetrics_tpu.classification.accuracy\nMulticlassAccuracy\n)\x81}b."
    pseq = prod._data("add", "alien", ("__metric__", jax_blob))
    prod.flush(30.0)
    if [e[0] for e in prod.errors] != [pseq] or "metrics_tpu.classification" not in prod.errors[0][3]:
        fail(f"serve refusals: the JAX-package blob got {prod.errors}")
    if "metrics_tpu" in sys.modules or "jax" in sys.modules:
        fail("serve refusals: a refused blob imported the JAX package")
    prod.add_session(MulticlassAccuracy(num_classes=8, validate_args=False, device="cpu"), session_id="s0")
    prod.submit("s0", np.arange(8), np.arange(8))
    prod.flush(30.0)
    engine.tick()
    if len(engine) != 1 or prod.errors[1:]:
        fail(f"serve refusals: the reactor did not serve on ({len(engine)} sessions, {prod.errors})")
    out = {"protocol_errors": server.protocol_errors, "disconnects": server.disconnects,
           "err_reason": prod.errors[0][3][:160]}
    evil.close()
    prod.close()
    server.close()
    return out


def serve_section(seed: int, wrappers: dict) -> dict:
    """The front door on the card, its launches counted apart from the main path's: (a) 10,000 and 1,000
    served streams (one dispatch and one binned-counts launch a tick, host syncs a tick equal at both sizes),
    (b) the kill -9 leg, (c) the overload soak, (d) 8 shards and a resize, (e) refusals, then
    ``run_serve_smoke()`` on the card."""
    from metrics_tpu_torch.serve.smoke import run_serve_smoke

    res = {}
    t0 = time.perf_counter()
    res["streams_10000"] = serve_streams(FLEET_STREAMS, seed, wrappers)
    log(f"serve streams_10000: {json.dumps(res['streams_10000'])}")
    res["streams_1000"] = serve_streams(FLEET_SMALL, seed + 7, wrappers)
    log(f"serve streams_1000: {json.dumps(res['streams_1000'])}")
    big, little = res["streams_10000"]["ticks"], res["streams_1000"]["ticks"]
    for t, (a, b) in enumerate(zip(big, little)):
        if a["launches"] != b["launches"] or a["syncs"] != b["syncs"]:
            fail(f"served tick {t}: 10,000 streams launched {a['launches']} with {a['syncs']} host syncs, 1,000 "
                 f"streams {b['launches']} with {b['syncs']}")
    own = [t["syncs"] for t in APART["fleet_engine"]["streams_10000"]["ticks"]] if "fleet_engine" in APART else []
    res["engine_own_tick_syncs_10000"] = own
    if own and [t["syncs"] for t in big] != own:
        fail(f"served ticks synchronized {[t['syncs'] for t in big]} times, the engine's own ticks {own}")
    res["crash"] = serve_crash(seed)
    log(f"serve crash: {json.dumps(res['crash'])}")
    res["overload"] = serve_overload(seed)
    log(f"serve overload: {json.dumps(res['overload'])}")
    res["sharded"] = serve_sharded(seed)
    log(f"serve sharded: {json.dumps(res['sharded'])}")
    res["refusals"] = serve_refusals()
    log(f"serve refusals: {json.dumps(res['refusals'])}")
    smoke = run_serve_smoke()
    if not smoke["ok"]:
        fail(f"run_serve_smoke on the card: {smoke['failures']}")
    res["run_serve_smoke"] = smoke
    res["launches_1000"] = {k: sum(t["launches"][k] for t in little) for k in wrappers}
    res["launches"] = {k: sum(t["launches"][k] for t in big + little) for k in wrappers}
    res["seconds"] = time.perf_counter() - t0
    log(f"serve: {json.dumps({k: res[k] for k in ('run_serve_smoke', 'launches', 'launches_1000', 'seconds')})}")
    return res


# ----------------------------------------------------------------------------- phase 4, model-based image metrics
# CIFAR-10's size for FID/KID/IS/MiFID (10,000 real and 10,000 generated 32 x 32 images, resized to 299 as
# torch-fidelity does), BAPPS' 64 x 64 patches for LPIPS, and PPL's 2,000 samples; random weights from the port's
# own seeded init (the repository holds no pretrained weights)
GEN_IMAGES, GEN_BATCH, GEN_SIZE, GEN_SUBSET = 10_000, 250, 32, 64
GEN_KID = {"subsets": 100, "subset_size": 1000}  # KID's defaults, the reference's
LPIPS_PAIRS, LPIPS_BATCH, LPIPS_SIZE, LPIPS_SUBSET = 10_000, 500, 64, 100
PPL_SAMPLES, PPL_BATCH, PPL_SUBSET = 2_000, 64, 128
TAP_ATOL_OF_SCALE, TAP_RTOL = 1e-5, 1e-4  # Inception taps, as tests/test_torch_models.py holds them
GEN_VALUE_RTOL = {"fid": 1e-4, "mifid": 1e-4, "kid": 1e-4, "is": 1e-4}  # see model_based_generative
LPIPS_RTOL, PPL_RTOL = 1e-4, 1e-3  # as tests/test_torch_model_based.py holds LPIPS and PPL


def _gen_members(extractor, dev, subset: bool = False) -> dict:
    from metrics_tpu_torch.image import (
        FrechetInceptionDistance,
        InceptionScore,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )

    kid = dict(subsets=10, subset_size=16) if subset else GEN_KID
    return {"fid": FrechetInceptionDistance(feature=extractor, device=dev),
            "kid": KernelInceptionDistance(feature=extractor, device=dev, **kid),
            "is": InceptionScore(feature=extractor, splits=2 if subset else 10, device=dev),
            "mifid": MemorizationInformedFrechetInceptionDistance(feature=extractor, device=dev)}


def _gen_values(fs) -> dict:
    out, ms = {}, {}
    for name, metric in fs.items():
        value, ms[name] = _wall(metric.compute, "cuda" if metric.device.type == "cuda" else "cpu")
        out[name] = [float(v) for v in value] if isinstance(value, tuple) else float(value)
    return out, ms


def model_based_generative(seed: int, dev="cuda") -> dict:
    """FID, KID, IS and MiFID in ONE FeatureShare over the FID InceptionV3 (2048 tap) at CIFAR-10's size:
    10,000 real and 10,000 generated uint8 images in batches of 250, one Inception forward a batch. Then a
    64-image subset (32 + 32) through the card and through the port on the CPU: the 2048 features within the
    taps' tolerance and the four values within ``GEN_VALUE_RTOL``, ten times the CPU tests' 1e-5 for FID and
    MiFID: at 32 samples of 2,048 features the covariances have rank 31, and the square root's trace sums ~2,000
    eigenvalues that are zero up to each device's rounding."""
    from metrics_tpu_torch.models import init_inception_params, make_feature_extractor
    from metrics_tpu_torch.wrappers import FeatureShare

    g = torch.Generator(device=dev).manual_seed(seed + 60)
    real = torch.randint(0, 256, (GEN_IMAGES, 3, GEN_SIZE, GEN_SIZE), generator=g, device=dev, dtype=torch.uint8)
    noise = torch.randint(-40, 41, real.shape, generator=g, device=dev, dtype=torch.int16)
    fake = (real.to(torch.int16) // 2 + 64 + noise).clamp(0, 255).to(torch.uint8)
    state = init_inception_params(seed, device=dev)
    inner = make_feature_extractor(state, 2048)
    forwards = {"n": 0}

    def extractor(x):
        forwards["n"] += 1
        return inner(x)

    fs = FeatureShare(_gen_members(extractor, dev))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    update_ms, updates = [], 0
    for i in range(0, GEN_IMAGES, GEN_BATCH):
        for imgs, is_real in ((real[i:i + GEN_BATCH], True), (fake[i:i + GEN_BATCH], False)):
            _, ms = _wall(lambda: fs.update(imgs, real=is_real), dev)
            update_ms.append(ms)
            updates += 1
    if forwards["n"] != updates:
        fail(f"FeatureShare: {forwards['n']} Inception forwards over {updates} updates; want one a batch")
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != tf32:
        fail("the Inception forwards left the caller's TF32 settings changed")
    values, compute_ms = _gen_values(fs)
    for name, v in values.items():
        if not np.all(np.isfinite(v)):
            fail(f"{name} at CIFAR-10's size is not finite: {v}")
    # the subset on both devices: features, then values
    sub_r, sub_f = real[: GEN_SUBSET // 2], fake[: GEN_SUBSET // 2]
    cpu_extract = make_feature_extractor({k: v.cpu() for k, v in state.items()}, 2048)
    feats = {"card": [inner(sub_r).cpu(), inner(sub_f).cpu()], "cpu": [cpu_extract(sub_r.cpu()),
                                                                      cpu_extract(sub_f.cpu())]}
    worst_feat = 0.0
    for a, b in zip(feats["card"], feats["cpu"]):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst_feat = max(worst_feat, err / scale)
        if not torch.allclose(a, b, rtol=TAP_RTOL, atol=TAP_ATOL_OF_SCALE * scale):
            fail(f"Inception 2048 features on the card differ from the CPU's by {err} (scale {scale})")
    sub_vals = {}
    for key, d, ext in (("card", dev, inner), ("cpu", "cpu", cpu_extract)):
        sub = FeatureShare(_gen_members(ext, d, subset=True))
        sub.update(sub_r.to(d), real=True)
        sub.update(sub_f.to(d), real=False)
        sub_vals[key], _ = _gen_values(sub)
    for name, rtol in GEN_VALUE_RTOL.items():
        if not np.allclose(sub_vals["card"][name], sub_vals["cpu"][name], rtol=rtol, atol=0):
            fail(f"{name} of the 64-image subset: {sub_vals['card'][name]} on the card, {sub_vals['cpu'][name]} "
                 "on the CPU")
    total_s = sum(update_ms) / 1000
    return {"images": 2 * GEN_IMAGES, "batch": GEN_BATCH, "inception_forwards": forwards["n"],
            "images_per_s": 2 * GEN_IMAGES / total_s, "update_ms_median": float(np.median(update_ms)),
            "update_ms_first": update_ms[0], "compute_ms": compute_ms, "values": values,
            "subset_values": sub_vals, "subset_feature_max_err_of_scale": worst_feat}


def _lpips_weights(directory: str, seed: int) -> None:
    """Random towers and heads as the local ``.pth`` files the hub reads (torchvision and LPIPS layouts)."""
    from metrics_tpu_torch.models import init_lpips
    from metrics_tpu_torch.models.lpips_nets import ALEX_TAPS, SQUEEZE_TAPS, VGG16_TAPS

    g = torch.Generator().manual_seed(seed)
    for net, backbone, taps in (("vgg", "vgg16", VGG16_TAPS), ("alex", "alexnet", ALEX_TAPS),
                                ("squeeze", "squeezenet1_1", SQUEEZE_TAPS)):
        state, _ = init_lpips(net, rng_seed=seed, device="cpu")
        torch.save(state, os.path.join(directory, f"{backbone}.pth"))
        torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) for i, c in enumerate(taps)},
                   os.path.join(directory, f"lpips_{net}.pth"))


def model_based_lpips(seed: int, weights: str, dev="cuda") -> dict:
    """LPIPS through each tower (VGG16, AlexNet, SqueezeNet) resolved from local weights: 10,000 pairs of
    BAPPS-sized 64 x 64 patches in batches of 500, and the first 100 pairs on the CPU within ``LPIPS_RTOL``."""
    from metrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity

    g = torch.Generator(device=dev).manual_seed(seed + 61)
    a = torch.rand((LPIPS_PAIRS, 3, LPIPS_SIZE, LPIPS_SIZE), generator=g, device=dev) * 2 - 1
    b = (a + 0.3 * torch.randn(a.shape, generator=g, device=dev)).clamp(-1, 1)
    os.environ["METRICS_TPU_WEIGHTS"] = weights
    res = {}
    for net in ("vgg", "alex", "squeeze"):
        m = LearnedPerceptualImagePatchSimilarity(net_type=net, device=dev)
        ms = [_wall(lambda i=i: m.update(a[i:i + LPIPS_BATCH], b[i:i + LPIPS_BATCH]), dev)[1]
              for i in range(0, LPIPS_PAIRS, LPIPS_BATCH)]
        value = float(m.compute())
        sub = {}
        for key, d in (("card", dev), ("cpu", "cpu")):
            s = LearnedPerceptualImagePatchSimilarity(net_type=net, device=d)
            s.update(a[:LPIPS_SUBSET].to(d), b[:LPIPS_SUBSET].to(d))
            sub[key] = float(s.compute())
        if not (np.isfinite(value) and value > 0 and abs(sub["card"] - sub["cpu"]) <= LPIPS_RTOL * abs(sub["cpu"])):
            fail(f"LPIPS {net}: {value} over the pairs; the subset {sub['card']} on the card, {sub['cpu']} on the CPU")
        res[net] = {"value": value, "pairs_per_s": LPIPS_PAIRS / (sum(ms) / 1000),
                    "update_ms_median": float(np.median(ms)), "subset": sub}
    return res


class _SmallGenerator(torch.nn.Module):
    """A random generator of 64 x 64 images in [0, 255]: a 128-wide latent through a linear layer and two
    upsampling convolutions. ``sample`` draws latents on the CPU, so the card and the CPU see the same ones."""

    def __init__(self, seed: int):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc = torch.nn.Linear(128, 64 * 16 * 16)
        self.conv1 = torch.nn.Conv2d(64, 32, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(32, 3, 3, padding=1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(max(1, p[0].numel() if p.ndim > 1 else 1)))
        self._draws = torch.Generator().manual_seed(seed + 1)

    def sample(self, n):
        return torch.randn((n, 128), generator=self._draws).to(self.fc.weight.device)

    @torch.no_grad()
    def forward(self, z):
        from metrics_tpu_torch.models._backbone import exact_fp32

        # TF32 off here too: a pair's two images differ by epsilon, and TF32's rounding would swamp that
        with exact_fp32():
            x = self.fc(z).reshape(-1, 64, 16, 16)
            x = F.relu(self.conv1(F.interpolate(x, scale_factor=2.0)))
            x = self.conv2(F.interpolate(x, scale_factor=2.0))
        return 255 * torch.sigmoid(x)


def model_based_ppl(seed: int, dev="cuda") -> dict:
    """PPL with the VGG LPIPS over a small random generator: 2,000 samples in batches of 64 (epsilon 1e-4); then
    128 samples at epsilon 1e-2 on the card and on the CPU, within ``PPL_RTOL``."""
    from metrics_tpu_torch.image import PerceptualPathLength
    from metrics_tpu_torch.models import build_lpips, init_lpips

    state, lin = init_lpips("vgg", rng_seed=seed, device=dev)
    scorer = build_lpips("vgg", state, lin, device=dev)
    gen = _SmallGenerator(seed + 62).to(dev)
    ppl = PerceptualPathLength(num_samples=PPL_SAMPLES, batch_size=PPL_BATCH, sim_net=scorer, device=dev)
    ppl.update(gen)
    (mean, std, dists), ms = _wall(ppl.compute, dev)
    if not (np.isfinite(float(mean)) and np.isfinite(float(std)) and dists.numel() > 0.9 * PPL_SAMPLES):
        fail(f"PPL: mean {float(mean)}, std {float(std)} over {dists.numel()} kept distances")
    sub = {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        s_state, s_lin = init_lpips("vgg", rng_seed=seed, device=d)
        m = PerceptualPathLength(num_samples=PPL_SUBSET, batch_size=PPL_BATCH, epsilon=1e-2, lower_discard=None,
                                 upper_discard=None, sim_net=build_lpips("vgg", s_state, s_lin, device=d), device=d)
        m.update(_SmallGenerator(seed + 62).to(d))
        sub[key] = m.compute()[2].cpu()
    if not torch.allclose(sub["card"], sub["cpu"], rtol=PPL_RTOL, atol=PPL_RTOL * float(sub["cpu"].abs().max())):
        fail(f"PPL distances on the card differ from the CPU's by {float((sub['card'] - sub['cpu']).abs().max())}"
             f" (largest {float(sub['cpu'].abs().max())})")
    return {"samples": PPL_SAMPLES, "batch": PPL_BATCH, "mean": float(mean), "std": float(std),
            "kept": dists.numel(), "compute_ms": ms, "samples_per_s": PPL_SAMPLES / (ms / 1000),
            "subset_max_rel_err": float(((sub["card"] - sub["cpu"]).abs() / sub["cpu"].abs().clamp(min=1e-30)).max())}


def model_based_section(seed: int, wrappers: dict) -> dict:
    """The model-based image metrics on the card, their launches counted apart (none is expected): FID, KID, IS
    and MiFID through one shared InceptionV3, LPIPS through its three towers, PPL."""
    import shutil
    import tempfile

    res = {}
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    res["generative_cifar10"] = model_based_generative(seed)
    log(f"model_based generative: {json.dumps(res['generative_cifar10'])}")
    weights = tempfile.mkdtemp(prefix="lpips_weights_")
    saved = os.environ.get("METRICS_TPU_WEIGHTS")
    try:
        _lpips_weights(weights, seed)
        res["lpips_bapps"] = model_based_lpips(seed, weights)
        log(f"model_based lpips: {json.dumps(res['lpips_bapps'])}")
    finally:
        if saved is None:
            os.environ.pop("METRICS_TPU_WEIGHTS", None)
        else:
            os.environ["METRICS_TPU_WEIGHTS"] = saved
        shutil.rmtree(weights, ignore_errors=True)
    res["ppl"] = model_based_ppl(seed)
    res["launches"] = {k: w.launches for k, w in wrappers.items()}
    res["seconds"] = time.perf_counter() - t0
    log(f"model_based: {json.dumps({k: res[k] for k in ('ppl', 'launches', 'seconds')})}")
    return res


# ----------------------------------------------------------------------------- model-based text and multimodal
# The encoders below are synthetic: the repository holds no weights. Token embeddings, per-token distributions
# and image and text embeddings come from seeded torch.Generator draws and a fixed random projection of the
# inputs (a text's words hashed to ids; an image's pixels), computed on the card.
MB_PAIRS, MB_TOKENS = 3_003, (10, 60)  # WMT14 newstest2014 en-de; reference token counts drawn over 10-60
MB_DIM, MB_VOCAB = 1_024, 32_768  # roberta-large's token embeddings; hashed word ids
MLM_VOCAB, MLM_DIM = 30_522, 256  # bert-base-uncased's vocabulary; the distributions' hidden width
COCO_IMAGES, CLIP_BATCH, CLIP_DIM = 5_000, 500, 768  # MS-COCO val2017, one caption an image; ViT-L/14's projection
CLIP_IMAGE = (3, 224, 224)
MB_CPU_PAIRS, INFOLM_CPU_PAIRS, CLIP_CPU_IMAGES = 64, 16, 100  # the stated subsets the CPU run repeats
MB_RTOL = 1e-5
HF_CLIP_IMAGES, HF_TEXT_PAIRS = 256, 512  # what the default (Hugging Face) paths score, for their throughput
HF_CPU_ITEMS, HF_FEATURE_RTOL = 8, 1e-5  # images, captions and sentences whose features the CPU run repeats;
# the card's features within HF_FEATURE_RTOL of the CPU's largest magnitude (float32 forwards under exact_fp32)
HF_CLIP = dict(  # ViT-L/14's published widths (openai/clip-vit-large-patch14)
    vision_config=dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
                       patch_size=14, image_size=224, projection_dim=768),
    text_config=dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                     vocab_size=49_408, max_position_embeddings=77, projection_dim=768),
    projection_dim=768)
HF_ROBERTA = dict(vocab_size=50_265, hidden_size=1_024, num_hidden_layers=24, num_attention_heads=16,
                  intermediate_size=4_096, max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
                  bos_token_id=0, eos_token_id=2)  # roberta-large's published widths


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _word_ids(texts, vocab: int) -> list:
    import zlib

    return [[zlib.crc32(w.encode()) % vocab for w in t.split()] for t in texts]


class _SyntheticText:
    """Per-token rows of hashed word ids: ``E[ids] @ P`` (an embedding), or a softmax over ``V`` of
    ``E[ids] @ W`` (a distribution), computed on the card for all the texts of a call at once and handed back
    as one view per text; a call's result is kept for the same texts (one forward per text list)."""

    def __init__(self, g: torch.Generator, vocab: int, dim: int, out: int, softmax: bool):
        self.table = torch.randn(vocab, dim, generator=g, device=g.device)
        self.proj = torch.randn(dim, out, generator=g, device=g.device) / math.sqrt(dim)
        self.vocab, self.softmax, self.memo = vocab, softmax, {}

    def __call__(self, texts) -> list:
        key = tuple(texts)
        if key not in self.memo:
            ids = _word_ids(texts, self.vocab)
            flat = torch.tensor([i for row in ids for i in row], dtype=torch.int64).to(self.table.device)
            rows = self.table[flat] @ self.proj
            if self.softmax:
                rows.sub_(rows.amax(-1, keepdim=True)).exp_()
                rows.div_(rows.sum(-1, keepdim=True))
            self.memo[key] = list(torch.split(rows, [len(r) for r in ids]))
        return self.memo[key]

    def on_cpu(self, texts) -> list:
        """The same rows, copied to the host: the CPU run scores the card's embeddings."""
        return [r.cpu() for r in self(texts)]


def _mb_pairs(rng: np.random.Generator, n: int):
    vocab = _vocabulary(rng, 5_000)
    refs, hyps = [], []
    for k in rng.integers(MB_TOKENS[0], MB_TOKENS[1] + 1, n):
        ref = _draw(rng, vocab, int(k))
        refs.append(" ".join(ref))
        hyps.append(" ".join(_corrupt_tokens(rng, ref, vocab, 0.2, 0.03, 0.03) or ref[:1]))
    return hyps, refs, vocab


def _mb_compute(name, make, pairs, res):
    """Update with every pair on the card, time a first ``compute()`` and its peak memory."""
    m = make("cuda")
    m.update(*pairs)
    base = _reset_peak()
    t0 = time.perf_counter()
    value = m.compute()
    torch.cuda.synchronize()
    res[name] = {"compute_ms": 1000 * (time.perf_counter() - t0), "peak_mb": _peak_mb(base)}
    return m, value


def _finite(name, value):
    vals = list(value.values()) if isinstance(value, dict) else [value]
    if not all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in vals):
        fail(f"{name}: non-finite result on the card")


def mb_bert_infolm(seed: int) -> dict:
    """BERTScore and InfoLM (each measure) over WMT14's pairs, each against the CPU run of a subset."""
    from metrics_tpu_torch.text import BERTScore, InfoLM
    from metrics_tpu_torch.text.model_based import _CHUNK_BYTES

    res = {"pairs": MB_PAIRS, "float64_chunk_mb": _CHUNK_BYTES / 2**20}
    rng = np.random.default_rng(seed + 41)
    hyps, refs, _ = _mb_pairs(rng, MB_PAIRS)
    g = torch.Generator(device="cuda").manual_seed(seed + 41)
    enc = _SyntheticText(g, MB_VOCAB, MB_DIM, MB_DIM, softmax=False)
    dist = _SyntheticText(g, MB_VOCAB, MLM_DIM, MLM_VOCAB, softmax=True)
    res["tokens"] = int(sum(len(t.split()) for t in hyps + refs))
    for fn in (enc, dist):  # the encoders' forwards, out of the computes' times
        fn(hyps)
        fn(refs)

    _, value = _mb_compute("bert_score", lambda d: BERTScore(encoder=enc, device=d), (hyps, refs), res)
    _finite("BERTScore", value)
    res["bert_score"]["f1"] = float(value["f1"])
    sub = (hyps[:MB_CPU_PAIRS], refs[:MB_CPU_PAIRS])
    card, host = BERTScore(encoder=enc, device="cuda"), BERTScore(encoder=enc.on_cpu, device="cpu")
    card.update(*sub)
    host.update(*sub)
    got, want = card.compute(), host.compute()
    res["bert_score"]["cpu_subset_max_rel"] = max(
        _agree(f"BERTScore[{k}]", got[k], want[k], False, MB_RTOL, 0.0) / max(abs(float(want[k])), 1e-30)
        for k in want)

    sub = (hyps[:INFOLM_CPU_PAIRS], refs[:INFOLM_CPU_PAIRS])
    for measure in InfoLM._MEASURES:
        name = f"infolm[{measure}]"
        make = lambda d, fn=dist: InfoLM(distribution_fn=fn, information_measure=measure, device=d)  # noqa: E731
        _, value = _mb_compute(name, make, (hyps, refs), res)
        _finite(name, value)
        res[name]["value"] = float(value)
        card, host = make("cuda"), make("cpu", dist.on_cpu)
        card.update(*sub)
        host.update(*sub)
        _agree(name, card.compute_sentence_scores(), host.compute_sentence_scores(), False, MB_RTOL, 0.0)
    dist.memo.clear()
    enc.memo.clear()
    return res


def mb_clip(seed: int) -> dict:
    """CLIPScore and CLIP-IQA (all 16 prompts) over MS-COCO's images, each against the CPU run of a subset."""
    from metrics_tpu_torch.functional.multimodal.clip_iqa import _PROMPTS
    from metrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore

    res = {"images": COCO_IMAGES}
    rng = np.random.default_rng(seed + 43)
    vocab = _vocabulary(rng, 5_000)
    captions = [" ".join(_draw(rng, vocab, int(k))) for k in rng.integers(8, 16, COCO_IMAGES)]
    g = torch.Generator(device="cuda").manual_seed(seed + 43)
    pix = int(np.prod(CLIP_IMAGE))
    # each image is drawn from its caption's embedding through a random decoder, plus noise, and the image
    # encoder projects back through the decoder: a pair's embeddings correlate, as a captioned photo's do
    decoder = torch.randn(CLIP_DIM, pix, generator=g, device="cuda") / math.sqrt(CLIP_DIM)
    txt = _SyntheticText(g, MB_VOCAB, CLIP_DIM, CLIP_DIM, softmax=False)

    def image_encoder(images):
        return (images.reshape(len(images), -1).to("cuda") - 0.5) @ decoder.T

    def text_encoder(texts):
        return torch.stack([r.sum(0) for r in txt(texts)])

    def cpu(fn):
        return lambda x: fn(x).cpu()

    batches = []
    for i in range(0, COCO_IMAGES, CLIP_BATCH):
        caps = captions[i:i + CLIP_BATCH]
        signal = torch.sigmoid(_unit_rows(text_encoder(caps)) @ decoder).reshape(len(caps), *CLIP_IMAGE)
        batches.append((0.5 * signal + 0.5 * torch.rand((len(caps), *CLIP_IMAGE), generator=g, device="cuda"), caps))
    prompts = tuple(_PROMPTS)
    for name, make, feed in (
            ("clip_score", lambda d, i=image_encoder, t=text_encoder: CLIPScore(
                image_encoder=i, text_encoder=t, device=d), lambda m, b: m.update(*b)),
            ("clip_iqa", lambda d, i=image_encoder, t=text_encoder: CLIPImageQualityAssessment(
                prompts=prompts, image_encoder=i, text_encoder=t, device=d), lambda m, b: m.update(b[0]))):
        m = make("cuda")
        base = _reset_peak()
        t0 = time.perf_counter()
        for b in batches:
            feed(m, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        value = m.compute()
        torch.cuda.synchronize()
        res[name] = {"update_ms": 1000 * (t1 - t0), "compute_ms": 1000 * (time.perf_counter() - t1),
                     "peak_mb": _peak_mb(base)}
        _finite(name, value)
        card = make("cuda")
        host = (CLIPScore(image_encoder=cpu(image_encoder), text_encoder=cpu(text_encoder), device="cpu")
                if name == "clip_score" else CLIPImageQualityAssessment(
                    prompts=prompts, image_encoder=cpu(image_encoder), text_encoder=cpu(text_encoder), device="cpu"))
        sub = (batches[0][0][:CLIP_CPU_IMAGES], batches[0][1][:CLIP_CPU_IMAGES])
        feed(card, sub)
        feed(host, (sub[0].cpu(), sub[1]))
        got, want = card.compute(), host.compute()
        if isinstance(want, dict):
            if list(got) != list(want) or len(want) != 16:
                fail(f"{name}: prompts {list(got)} on the card, {list(want)} on the CPU")
            for k in want:
                _agree(f"{name}[{k}]", got[k], want[k], False, MB_RTOL, 1e-7)
            res[name]["mean_quality"] = float(value["quality"].mean())
        else:
            _agree(name, got, want, False, MB_RTOL, 0.0)
            res[name]["value"] = float(value)
    txt.memo.clear()
    return res


def _bpe_files(directory: str, words) -> None:
    """A hand-written CLIP BPE vocabulary: the special tokens, every byte-level character alone and word-final,
    and ``words`` whole; no merges (``merges.txt`` holds only its header)."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for w in words:
        vocab.setdefault(w + "</w>", len(vocab))
    for c in "abcdefghijklmnopqrstuvwxyz0123456789.,'!?":
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    with open(os.path.join(directory, "vocab.json"), "w") as fh:
        json.dump(vocab, fh)
    with open(os.path.join(directory, "merges.txt"), "w") as fh:
        fh.write("#version: 0.2\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "model_max_length": 77}, fh)
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as fh:
        json.dump({"image_processor_type": "CLIPImageProcessor", "do_resize": True, "size": {"shortest_edge": 224},
                   "do_center_crop": True, "crop_size": {"height": 224, "width": 224}, "do_rescale": False,
                   "do_normalize": True, "image_mean": [0.48145466, 0.4578275, 0.40821073],
                   "image_std": [0.26862954, 0.26130258, 0.27577711], "resample": 3, "do_convert_rgb": False}, fh)


def _wordpiece_files(directory: str, words) -> None:
    """A hand-written WordPiece vocabulary (``[PAD]`` at roberta's pad id 1) read by ``BertTokenizer``."""
    with open(os.path.join(directory, "vocab.txt"), "w") as fh:
        fh.write("\n".join(["[UNK]", "[PAD]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(words))) + "\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True, "model_max_length": 512}, fh)


def _features_agree(name: str, got, want) -> float:
    """The card's encoder features (a tensor or a list of them) against the CPU's: finite, the same shapes, and
    within ``HF_FEATURE_RTOL`` of the CPU's largest magnitude. Returns the difference over that magnitude."""
    got = [t.cpu().double() for t in (got if isinstance(got, (list, tuple)) else [got])]
    want = [t.cpu().double() for t in (want if isinstance(want, (list, tuple)) else [want])]
    if [t.shape for t in got] != [t.shape for t in want]:
        fail(f"{name}: features of shapes {[tuple(t.shape) for t in got]} on the card, "
             f"{[tuple(t.shape) for t in want]} on the CPU")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        fail(f"{name}: non-finite features on the card")
    scale = max(float(t.abs().max()) for t in want)
    rel = max(float((g - w).abs().max()) for g, w in zip(got, want)) / max(scale, 1e-30)
    if not rel <= HF_FEATURE_RTOL:
        fail(f"{name}: the card's features differ from the CPU's by {rel} of their scale {scale}")
    return rel


def mb_default_paths(seed: int) -> dict:
    """``load_clip`` and ``load_text_encoder`` (through ``CLIPScore`` and ``BERTScore`` with no encoder) over
    random checkpoints of the published widths, saved to a temporary directory with hand-written vocabularies.
    The encoders' features on the card are held against the same checkpoints' on the CPU for a few inputs."""
    import shutil
    import tempfile

    import transformers

    from metrics_tpu_torch.models import load_clip, load_text_encoder
    from metrics_tpu_torch.multimodal import CLIPScore
    from metrics_tpu_torch.text import BERTScore

    res = {"transformers": transformers.__version__}
    rng = np.random.default_rng(seed + 47)
    root = tempfile.mkdtemp(prefix="hf_random_")
    try:
        vocab = _vocabulary(rng, 2_000)
        captions = [" ".join(_draw(rng, vocab, int(k))) for k in rng.integers(5, 12, HF_CLIP_IMAGES)]
        clip_dir = os.path.join(root, "clip-vit-large-patch14")
        os.makedirs(clip_dir)
        t0 = time.perf_counter()
        torch.manual_seed(seed + 47)
        with torch.device("cuda"):
            model = transformers.CLIPModel(transformers.CLIPConfig(**HF_CLIP))
        model.save_pretrained(clip_dir)
        del model
        _bpe_files(clip_dir, vocab[0])
        res["clip_setup_s"] = time.perf_counter() - t0
        images = torch.rand((HF_CLIP_IMAGES, *CLIP_IMAGE), generator=torch.Generator().manual_seed(seed + 47))
        t0 = time.perf_counter()
        metric = CLIPScore(model_name_or_path=clip_dir, device="cuda")
        t1 = time.perf_counter()
        for i in range(0, HF_CLIP_IMAGES, 64):
            metric.update(images[i:i + 64], captions[i:i + 64])
        value = metric.compute()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _finite("CLIPScore[load_clip]", value)
        res["clip"] = {"load_s": t1 - t0, "images": HF_CLIP_IMAGES, "images_per_s": HF_CLIP_IMAGES / (t2 - t1),
                       "value": float(value)}
        # the score is a clamped mean, 0 for a random model: hold the unclamped features at full width instead
        host_image, host_text = load_clip(clip_dir, device="cpu")
        few_images, few_captions = images[:HF_CPU_ITEMS], captions[:HF_CPU_ITEMS]
        card_feats = (metric.image_encoder(few_images), metric.text_encoder(few_captions))
        if [f.shape[-1] for f in card_feats] != [HF_CLIP["projection_dim"]] * 2:
            fail(f"load_clip's encoders give widths {[f.shape[-1] for f in card_feats]}, "
                 f"not the projection's {HF_CLIP['projection_dim']}")
        res["clip"]["image_features_rel_err"] = _features_agree(
            "load_clip image features", card_feats[0], host_image(few_images))
        res["clip"]["text_features_rel_err"] = _features_agree(
            "load_clip text features", card_feats[1], host_text(few_captions))
        del metric, host_image, host_text
        shutil.rmtree(clip_dir, ignore_errors=True)

        hyps, refs, words = _mb_pairs(rng, HF_TEXT_PAIRS)
        text_dir = os.path.join(root, "roberta-large")
        os.makedirs(text_dir)
        t0 = time.perf_counter()
        with torch.device("cuda"):
            model = transformers.RobertaModel(transformers.RobertaConfig(**HF_ROBERTA), add_pooling_layer=False)
        model.save_pretrained(text_dir)
        del model
        _wordpiece_files(text_dir, words[0])
        res["roberta_setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        metric = BERTScore(model_name_or_path=text_dir, device="cuda")
        t1 = time.perf_counter()
        metric.update(hyps, refs)
        value = metric.compute()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _finite("BERTScore[load_text_encoder]", value)
        res["roberta"] = {"load_s": t1 - t0, "pairs": HF_TEXT_PAIRS, "pairs_per_s": HF_TEXT_PAIRS / (t2 - t1),
                          "f1": float(value["f1"])}
        res["roberta"]["token_features_rel_err"] = _features_agree(
            "load_text_encoder token features", metric.encoder(hyps[:HF_CPU_ITEMS]),
            load_text_encoder(text_dir, device="cpu")(hyps[:HF_CPU_ITEMS]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


def model_based_text_multimodal_section(seed: int, wrappers: dict) -> dict:
    """BERTScore, InfoLM, CLIPScore and CLIP-IQA on the card through synthetic injected encoders, then the
    default Hugging Face paths over random checkpoints; launches counted apart (none is expected)."""
    res = {}
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    res["wmt14"] = mb_bert_infolm(seed)
    log(f"model_based_text_multimodal wmt14: {json.dumps(res['wmt14'])}")
    res["coco"] = mb_clip(seed)
    log(f"model_based_text_multimodal coco: {json.dumps(res['coco'])}")
    res["default_paths"] = mb_default_paths(seed)
    log(f"model_based_text_multimodal default paths: {json.dumps(res['default_paths'])}")
    res["launches"] = {k: w.launches for k, w in wrappers.items()}
    res["seconds"] = time.perf_counter() - t0
    log(f"model_based_text_multimodal: {json.dumps({k: res[k] for k in ('launches', 'seconds')})}")
    return res


# ----------------------------------------------------------------------------- observe: overhead, costs
COST_KERNEL_CASES = {"BinaryAUROC": "binned_counts", "BinaryAveragePrecision": "binned_counts",
                     "MulticlassAUROC": "binned_counts_labels", "StructuralSimilarityIndexMeasure": "ssim_window",
                     "UniversalImageQualityIndex": "ssim_window"}


def observe_costs_section(seed: int, wrappers: dict) -> dict:
    """The telemetry overhead budget with its step loop on the card, every ``PROFILE_CASES`` entry profiled on
    the card against the committed (CPU-written) baseline, and the kernels each thresholded-curve and window
    case's update launches; launches counted apart."""
    from metrics_tpu_torch.observe import costs, overhead, profile

    res = {}
    t0 = time.perf_counter()
    report = {}
    if overhead.run_telemetry_check(".", report=report, device="cuda") != 0:
        fail(f"telemetry overhead over {overhead.MAX_OVERHEAD_PCT} %: {json.dumps(report)}")
    res["overhead_pct"] = {k: report[k]["overhead_pct"] for k in report}
    res["step_us"] = report["disabled_mode"]["step_us"]

    for w in wrappers.values():
        w.launches = 0
    results = costs.collect_cost_report(device="cuda")
    res["launches"] = {k: w.launches for k, w in wrappers.items()}
    baseline = profile.load_cost_baseline(profile._DEFAULT_BASELINE)
    ok = {r.case.name for r in results if r.ok}
    if ok != set(baseline):
        fail(f"cases profiled on the card {sorted(ok ^ set(baseline))} differ from the CPU baseline's")
    for r in results:
        if r.ok:
            for key in ("flops", "bytes_accessed", "shareable", "donation_eligible", "compile_count"):
                if r.cost[key] != baseline[r.case.name][key]:
                    fail(f"{r.case.name}: {key} {r.cost[key]} on the card, {baseline[r.case.name][key]} on the CPU")
            if "peak_memory_bytes" not in r.cost:
                fail(f"{r.case.name}: no peak memory on the card")
    regressions, stale, new = profile.diff_cost_baseline(results, baseline)
    if regressions or stale or new:
        fail(f"perf ratchet on the card: {regressions + stale + new}")
    res["profiled"] = f"{len(ok)}/{len(results)}"
    res["peak_memory_bytes"] = {r.case.name: r.cost.get("peak_memory_bytes") for r in results if r.ok}

    by = {c.name: c for c in costs.PROFILE_CASES}
    res["kernel_launches"] = {}
    for name, kernel in COST_KERNEL_CASES.items():
        m = by[name].ctor(device="cuda")
        batch = costs.case_batch(by[name], "cuda")
        for w in wrappers.values():
            w.launches = 0
        m.update(*batch)
        if m._has_list_state():  # UQI keeps its inputs and windows them at compute
            m.compute()
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items() if w.launches}
        for k, v in got.items():
            res["launches"][k] += v
        if got.get(kernel, 0) < 1:
            fail(f"the {name} cost case's update launched {got}, expected {kernel}")
        res["kernel_launches"][name] = got
    res["seconds"] = time.perf_counter() - t0
    log(f"observe_costs: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------------------- phase 4, the analysis contracts
# the classes whose registry case runs a kernel (the cost section's), the engine leg's sizes (the JAX
# package's 100 sessions and the fleet_engine section's 10,000 streams), and the full-size kernel classes of
# the transfer leg at the main path's shapes
CONTRACT_ENGINE_SESSIONS = (100, FLEET_STREAMS)
CONTRACT_CHAOS_CLASSES = ("BinaryAccuracy", "BinaryAUROC", "BinaryAveragePrecision", "MulticlassAUROC",
                          "StructuralSimilarityIndexMeasure")


def _sync_sites(fn) -> dict:
    """Where ``fn()`` synchronizes with the host: the innermost package frame of each sync, counted
    (``file:line``), through the transfer contract's recording guard."""
    from collections import Counter

    from metrics_tpu_torch.analysis.transfer_contracts import transfer_guard

    with transfer_guard("cuda", mode="warn") as guard:
        fn()
    torch.cuda.synchronize()
    return dict(Counter(guard.reads))


def _full_size_cases() -> list:
    """The kernel classes at the main path's shapes: B1 binary 2^22 x 200 thresholds, B1's labels mode
    2^20 x 10 classes x 200, B2 over 300 planes of 256² (100 RGB pairs); each with a CPU twin at 64 samples
    (the CPU leg predicts the class's verdict, not the size's)."""
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAUROC
    from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure
    from metrics_tpu_torch.observe.costs import ProfileCase

    def scores(n, c=None):
        def batch(rng):
            shape = (n,) if c is None else (n, c)
            s = torch.from_numpy(rng.rand(*shape).astype(np.float32))
            t = torch.from_numpy(rng.randint(0, 2 if c is None else c, n).astype(np.int64))
            return s, t
        return batch

    def images(n):
        def batch(rng):
            a = torch.from_numpy(rng.rand(n, 3, 256, 256).astype(np.float32))
            return a, (a * 0.9 + 0.05).clamp(0, 1)
        return batch

    out = []
    for name, ctor, big, small in (
        ("BinaryAUROC[2^22 x 200]", lambda device: BinaryAUROC(thresholds=200, device=device),
         scores(1 << 22), scores(64)),
        ("MulticlassAUROC[2^20 x 10 x 200]", lambda device: MulticlassAUROC(num_classes=10, thresholds=200,
                                                                             device=device),
         scores(1 << 20, 10), scores(64, 10)),
        ("StructuralSimilarityIndexMeasure[300 planes 256²]",
         lambda device: StructuralSimilarityIndexMeasure(data_range=1.0, device=device), images(100), images(2)),
    ):
        out.append((ProfileCase(name, ctor, big), ProfileCase(name, ctor, small)))
    return out


def analysis_contracts_section(seed: int, wrappers: dict) -> dict:
    """The analysis harness's runtime contracts on the card, each against the CPU's prediction or verdict:
    transfer (every registry case under ``set_sync_debug_mode("error")`` against the CPU dispatch-mode
    verdict, the kernel classes at the main path's shapes, the engine at 100 sessions and 10,000 streams with
    no sync outside ``_transfer_scope``), merge (73 classifications equal to the CPU's), precision (the
    registry and the five regimes), fleet (every bucketable case on CUDA buckets, the kernel classes
    launching B1/B2 through the ``vmap`` rules, and the eager-vs-vmapped gap of the classes whose float state
    is held within tolerance), chaos (the metric and fleet suites over the kernel classes
    and ``BinaryAccuracy``), static (jitlint, distlint, donlint and racelint over the port's source, clean
    against their baselines), abstract (every functional kernel on fake CUDA tensors, shapes and dtypes equal to
    the fake CPU trace's), donation (every jit-eligible case's 3-update lifecycle on the card, verdicts equal
    to the CPU's), interleave (1,100 schedules of the served engine with its sessions on the card), aot (a cold
    build into an empty cache in one process, then the aot contract over the registry against that cache, with
    no build of its own; none in the next); launches counted apart, per leg."""
    from metrics_tpu_torch import aot
    from metrics_tpu_torch.analysis import (
        abstract_contracts,
        chaos_contracts,
        donation_contracts,
        fleet_contracts,
        interleave_contracts,
        merge_contracts,
        precision_contracts,
        transfer_contracts,
    )
    from metrics_tpu_torch.analysis import cli as analysis_cli
    from metrics_tpu_torch.analysis import engine as lint_engine

    res: dict = {"seconds_by_leg": {}, "launches_by_leg": {}}
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    marks = {"launches": {k: 0 for k in wrappers}}

    def leg(name, t):
        res["seconds_by_leg"][name] = time.perf_counter() - t
        now = {k: w.launches for k, w in wrappers.items()}
        res["launches_by_leg"][name] = {k: now[k] - marks["launches"][k] for k in now}
        marks["launches"] = now
        return time.perf_counter()

    # ---- transfer: every case on the card against its CPU prediction
    t = time.perf_counter()
    cases = transfer_contracts.transfer_cases()
    card = {c.name: transfer_contracts.check_transfer_case(c, "cuda") for c in cases}
    cpu = {c.name: transfer_contracts.check_transfer_case(c, "cpu") for c in cases}
    for big, small in _full_size_cases():
        card[big.name] = transfer_contracts.check_transfer_case(big, "cuda")
        cpu[big.name] = transfer_contracts.check_transfer_case(small, "cpu")
    verdict = {name: r.runtime.split(":")[0] for name, r in card.items()}
    res["transfer"] = {
        "card": {k: sum(1 for v in verdict.values() if v == k) for k in ("CLEAN", "TRANSFER", "ERROR")},
        "card_verdicts": {name: r.runtime for name, r in card.items()},
        "cpu_disagreements": sorted(n for n in card if verdict[n] != cpu[n].runtime.split(":")[0]),
        "not_agreeing_on_card": sorted(n for n, r in card.items() if not r.agree),
    }
    bad = res["transfer"]["cpu_disagreements"] + res["transfer"]["not_agreeing_on_card"]
    if bad:
        by = {c.name: c for c in cases}
        by.update({b.name: b for b, _ in _full_size_cases()})
        sites = {}
        for name in sorted(set(bad)):
            m = by[name].ctor("cuda")
            batches = transfer_contracts._materialized_batches(by[name], 2, "cuda")
            m.update(*batches[0])
            sites[name] = {"card": card[name].render(), "cpu": cpu[name].render(),
                           "sites": _sync_sites(lambda: m.update(*batches[1]))}
        log(f"analysis_contracts: transfer disagreements: {json.dumps(sites)}")
        fail(f"transfer: the card's verdict differs from the CPU prediction, or the legs disagree: {sorted(set(bad))}")
    engine = {}
    bauroc = next(c for c in cases if c.name == "BinaryAUROC")
    for n in CONTRACT_ENGINE_SESSIONS:
        r = transfer_contracts.check_engine_contract("StreamEngine", "cuda", sessions=n, case=bauroc)
        engine[f"StreamEngine[{n}]"] = r.render()
        if r.runtime != "CLEAN" or not r.agree:
            fail(f"transfer: a {n}-session tick synchronized outside _transfer_scope: {r.render()}")
    r = transfer_contracts.check_engine_contract("ShardedStreamEngine", "cuda", case=bauroc)
    engine["ShardedStreamEngine[16]"] = r.render()
    if r.runtime != "CLEAN" or not r.agree:
        fail(f"transfer: the sharded churn tick synchronized outside _transfer_scope: {r.render()}")
    res["transfer"]["engine"] = engine
    t = leg("transfer", t)

    # ---- merge: the 73 classifications on the card equal the CPU's
    card_m = {r.case.name: r.classification for r in merge_contracts.run_merge_contracts(device="cuda")}
    cpu_m = {r.case.name: r.classification for r in merge_contracts.run_merge_contracts(device="cpu")}
    res["merge"] = {k: sum(1 for v in card_m.values() if v == k) for k in merge_contracts.CLASSIFICATIONS}
    if card_m != cpu_m or len(card_m) != 73:
        fail(f"merge: the card's classifications differ from the CPU's: "
             f"{ {k: (card_m.get(k), cpu_m.get(k)) for k in set(card_m) | set(cpu_m) if card_m.get(k) != cpu_m.get(k)} }")
    tshift = [r for r in merge_contracts.run_time_shifted_contracts(device="cuda") if not r.ok]
    if tshift:
        fail(f"merge: time-shifted merges diverge on the card: {[(r.case.name, r.detail) for r in tshift]}")
    t = leg("merge", t)

    # ---- precision: the registry and the five regimes
    prec = precision_contracts.collect_precision_report(device="cuda")
    res["precision"] = {"verdicts": {r.name: r.runtime for r in prec if r.name.startswith("regime:")},
                        "registry": {k: sum(1 for r in prec if not r.name.startswith("regime:")
                                            and r.runtime.split(":")[0] == k) for k in ("STABLE", "DRIFT", "ERROR")},
                        "regime_detail": {r.name: r.detail for r in prec if r.name.startswith("regime:")}}
    bad = [r.render() for r in prec if not r.agree]
    if bad:
        fail(f"precision: disagreements on the card: {bad}")
    t = leg("precision", t)

    # ---- fleet: every bucketable case on CUDA buckets; the kernel classes launch through the vmap rules
    verdicts, fleet_launches, close = {}, {}, {}
    for case in fleet_contracts.fleet_cases():
        before = {k: w.launches for k, w in wrappers.items()}
        r = fleet_contracts.check_fleet_case(case, "cuda")
        torch.cuda.synchronize()
        verdicts[case.name] = r.verdict
        if r.verdict == "CLOSE":
            close[case.name] = r.detail
        got = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches - before[k]}
        if not r.ok:
            fail(f"fleet: {r.render()}")
        if case.name in COST_KERNEL_CASES:
            fleet_launches[case.name] = got
            if not got:
                fail(f"fleet: {case.name}'s CUDA bucket launched no kernel")
    # the witness of the card's float-state tolerance (fleet CLOSE and the chaos poison row): the same batches
    # through eager updates and a bucket's vmapped update, each state's largest relative gap
    by_case = {c.name: c for c in fleet_contracts.fleet_cases()}
    witness = {name: fleet_contracts.eager_vs_bucket_gap(by_case[name], "cuda")
               for name in sorted(set(close) | {"StructuralSimilarityIndexMeasure"})}
    res["fleet"] = {"verdicts": {k: sum(1 for v in verdicts.values() if v == k) for k in ("EXACT", "CLOSE", "LOOSE")},
                    "close": close, "eager_vs_bucket": witness, "kernel_launches": fleet_launches}
    log(f"analysis_contracts: eager vs vmapped bucket update, largest relative gap per state: {json.dumps(witness)}")
    t = leg("fleet", t)

    # ---- chaos: the metric and fleet suites over the kernel classes and BinaryAccuracy
    by = {c.name: c for c in chaos_contracts.chaos_cases()}
    chaos = {}
    for name in CONTRACT_CHAOS_CLASSES:
        for suite in (chaos_contracts.check_chaos_case, chaos_contracts.check_fleet_chaos_case):
            r = suite(by[name], "cuda")
            if not r.ok:
                fail(f"chaos: {r.render()}")
            chaos.setdefault(name, []).extend(r.ran)
    res["chaos"] = {name: len(ran) for name, ran in chaos.items()}
    t = leg("chaos", t)

    # ---- static: the four newer packs over the port's source, clean against their baselines
    res["static"] = {}
    for name in ("jitlint", "distlint", "donlint", "racelint"):
        spec = analysis_cli._PASSES[name]
        result = lint_engine.lint_paths([lint_engine.PACKAGE_DIR], root=lint_engine.REPO_ROOT, rules=spec["rules"])
        baseline = lint_engine.load_baseline(spec["baseline"], section=spec.get("section", "entries"))
        new, baselined, stale = lint_engine.diff_against_baseline(result.violations, baseline)
        res["static"][name] = {"files": result.files_scanned, "new": len(new), "baselined": baselined,
                               "inline_suppressed": result.suppressed, "stale": len(stale)}
        if new or stale or result.parse_errors:
            fail(f"static: {name} is not clean against its baseline: {[v.render() for v in new]} stale {stale} "
                 f"{result.parse_errors}")
    t = leg("static", t)

    # ---- abstract: every functional kernel on fake CUDA tensors, as on fake CPU tensors
    card_a = abstract_contracts.verify_contracts(device="cuda")
    cpu_a = abstract_contracts.verify_contracts(device="cpu")
    bad = [f"{r.contract.name}: {r.error}" for r in card_a if not r.ok]
    bad += [r.contract.name for r, c in zip(card_a, cpu_a) if r.outputs != c.outputs]
    res["abstract"] = {"contracts": len(card_a), "clean": sum(r.ok for r in card_a)}
    if bad:
        fail(f"abstract: fake CUDA traces failed or differ from the CPU's: {bad}")
    t = leg("abstract", t)

    # ---- donation: every jit-eligible case on the card; the kernel classes launch B1 and B2
    card_d, cpu_d, kernel_launch = {}, {}, {}
    for case in donation_contracts.donation_cases():
        before = {k: w.launches for k, w in wrappers.items()}
        card_d[case.name] = donation_contracts.check_donation_case(case, "cuda")
        torch.cuda.synchronize()
        got = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches - before[k]}
        if case.name in COST_KERNEL_CASES:
            kernel_launch[case.name] = got
            if not got.get(COST_KERNEL_CASES[case.name]):
                fail(f"donation: {case.name} on the card launched no {COST_KERNEL_CASES[case.name]}")
        cpu_d[case.name] = donation_contracts.check_donation_case(case, "cpu")
    verdict = lambda r: (r.static_eligible, r.costs_eligible, r.runtime)  # noqa: E731
    res["donation"] = {"cases": len(card_d), "agree": sum(r.agree for r in card_d.values()),
                       "kernel_launches": kernel_launch}
    bad = [r.render() for r in card_d.values() if not r.agree]
    bad += [f"{n}: card {verdict(r)} cpu {verdict(cpu_d[n])}" for n, r in card_d.items() if verdict(r) != verdict(cpu_d[n])]
    if bad:
        fail(f"donation: disagreements on the card: {bad}")
    t = leg("donation", t)

    # ---- interleave: the full schedule set with the engine's sessions on the card
    report: dict = {}
    rc = interleave_contracts.run_interleave_check(os.getcwd(), report=report, device="cuda")
    res["interleave"] = {"schedules": report["schedules_explored"], "violations": sum(report["violations"].values()),
                         "explore_s": report["explore_wall_s"]}
    if rc or report["schedules_explored"] != interleave_contracts.DEFAULT_TARGET_SCHEDULES or report["violations"]:
        fail(f"interleave: {report['violations']} {report['details'][:5]}")
    t = leg("interleave", t)

    # ---- aot: the environment, a cold build into an empty cache in one process, then the aot contract over the
    # registry against that cache (it builds nothing more); none in the next
    res["aot"] = {"environment": aot.environment_fingerprint()}
    cache = os.path.join(os.path.abspath("chiprun_out"), f"kernel_cache_{os.getpid()}")
    try:
        for run in ("cold", "warm"):
            t1 = time.perf_counter()
            # the kernel cases' updates run the freshly built libraries; the other cases' were timed above
            out = subprocess.run([sys.executable, "-m", "metrics_tpu_torch.aot.warm", "--cache-dir", cache,
                                  "--device", "cuda", "--classes", ",".join(COST_KERNEL_CASES), "--json",
                                  *(("--contract",) if run == "cold" else ())],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                fail(f"aot: the {run} warm run failed: {out.stderr[-2000:]}")
            summary = json.loads(out.stdout.strip().splitlines()[-1])
            res["aot"][run] = {"seconds": time.perf_counter() - t1, "build_s": summary["built_s"],
                               "libraries": summary["libraries"], "cases": len(summary["cases"])}
            want = "built" if run == "cold" else "hit"
            if summary["error"] or len(summary["cases"]) != len(COST_KERNEL_CASES):
                fail(f"aot: the {run} run's kernel-case updates failed: {summary['cases']}")
            if set(summary["libraries"].values()) != {want}:
                fail(f"aot: the {run} run's libraries are {summary['libraries']}, expected all {want}")
            if run == "cold":
                verdicts = summary["contract"]
                res["aot"]["contract"] = {"verdicts": {v: sum(1 for x in verdicts.values() if x == v)
                                                       for v in sorted(set(verdicts.values()))},
                                          "kernel_classes": {n: verdicts.get(n) for n in COST_KERNEL_CASES},
                                          "roundtrip": sorted(n for n, v in verdicts.items() if v == "ROUNDTRIP"),
                                          "builds": summary["contract_builds"], "seconds": summary["contract_s"]}
                rebuilt = {n: o for n, o in summary["contract_builds"].items() if set(o) != {"hit"}}
                if summary["contract_failures"] or rebuilt:
                    fail(f"aot: the contract failed or built: {summary['contract_failures']} {rebuilt}")
                if any(verdicts.get(n) != "ROUNDTRIP" for n in COST_KERNEL_CASES):
                    fail(f"aot: a kernel class did not round-trip: { {n: verdicts.get(n) for n in COST_KERNEL_CASES} }")
    finally:
        aot.purge_cache(cache)
        if os.path.isdir(cache):
            os.rmdir(cache)
    leg("aot", t)

    res["launches"] = {k: w.launches for k, w in wrappers.items()}
    for k in ("binned_counts", "ssim_window"):
        if res["launches"][k] < 1:
            fail(f"analysis_contracts launched no {k}")
    res["seconds"] = time.perf_counter() - t0
    log(f"analysis_contracts: {json.dumps(res)}")
    return res


def measure(rng: np.random.Generator, plain: bool = True) -> dict:
    """Kernel, plain and library times at the main path's shapes; ``plain=False`` times the kernels only."""
    import torch.nn.functional as F

    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import (
        binned_counts,
        binned_counts_labels,
        binned_counts_labels_plain,
        binned_counts_plain,
    )
    from metrics_tpu_torch.ops.profile import flush_buffer, time_ms
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    def bound(moved, ops):
        return {"bound_ms": 1000 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S),
                "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"}

    def held(key, row, got, want, exact):
        """The row's ``max_abs_err``: the kernel against its plain version on the row's own inputs. Counts must
        be equal and window sums within SSIM_RTOL/SSIM_ATOL, or the run fails."""
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = 0.0
        for g, w in zip(got, want):
            err = max(err, float((g.double() - w.double()).abs().max()))
            if not (torch.equal(g, w) if exact else torch.allclose(g, w, rtol=SSIM_RTOL, atol=SSIM_ATOL)):
                fail(f"{key}: the kernel differs from its plain version on the timed inputs")
        row["max_abs_err"] = int(err) if exact else err

    flush = flush_buffer()
    res = {}
    t = PRC_THRESHOLDS
    thresholds = _adjust_threshold_arg(t, torch.device("cuda"))
    for label, n, c in [("binary", BIN_N, 1), ("multiclass", MC_N, 10), ("multilabel", ML_N, ML_LABELS)]:
        args = [
            torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
            torch.ones((n, c), dtype=torch.bool, device="cuda"),
            thresholds,
        ]
        moved = n * c * (4 + 4 + 1) + 4 * t + 4 * (2 * c * t + 2 * c)
        ops = n * c * math.ceil(math.log2(t + 1))
        res[f"binned_counts[{label}]"] = row = {
            "shape": [n, c, t],
            "ms": time_ms(lambda: binned_counts(*args), flush=flush),
            "plain_ms": time_ms(lambda: binned_counts_plain(*args), reps=5, flush=flush) if plain else None,
            **bound(moved, ops),
            "library_ms": None,
        }
        if plain:
            held(f"binned_counts[{label}]", row, binned_counts(*args), binned_counts_plain(*args), True)
    # B1 at the fleet's binary fold: the 5,000-session AUROC bucket padded to 8,192 rows, 16 scores a row, as
    # the vmap rule lays it out: (16, 8,192) columns at 16 thresholds, one launch a tick
    n, c, t16 = FLEET_BATCH, FLEET_CAPACITY, 16
    thr16 = _adjust_threshold_arg(t16, torch.device("cuda"))
    fargs = [torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
             torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
             torch.ones((n, c), dtype=torch.bool, device="cuda"), thr16]
    res["binned_counts[fleet_binary]"] = row = {
        "shape": [n, c, t16],
        "ms": time_ms(lambda: binned_counts(*fargs), flush=flush),
        "plain_ms": time_ms(lambda: binned_counts_plain(*fargs), reps=5, flush=flush) if plain else None,
        **bound(n * c * (4 + 4 + 1) + 4 * t16 + 4 * (2 * c * t16 + 2 * c), n * c * math.ceil(math.log2(t16 + 1))),
        "library_ms": None,
    }
    if plain:
        held("binned_counts[fleet_binary]", row, binned_counts(*fargs), binned_counts_plain(*fargs), True)
    # B1 at the served 1,000-stream fold: 500 AUROC sessions in a 1,024-row bucket, one launch a served tick
    c = _served_capacity(FLEET_SMALL // 2)
    sargs = [torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
             torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
             torch.ones((n, c), dtype=torch.bool, device="cuda"), thr16]
    res["binned_counts[served_binary]"] = row = {
        "shape": [n, c, t16],
        "ms": time_ms(lambda: binned_counts(*sargs), flush=flush),
        "plain_ms": time_ms(lambda: binned_counts_plain(*sargs), reps=5, flush=flush) if plain else None,
        **bound(n * c * (4 + 4 + 1) + 4 * t16 + 4 * (2 * c * t16 + 2 * c), n * c * math.ceil(math.log2(t16 + 1))),
        "library_ms": None,
    }
    if plain:
        held("binned_counts[served_binary]", row, binned_counts(*sargs), binned_counts_plain(*sargs), True)
    n, c = MC_N, 10
    largs = [torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
             torch.from_numpy(rng.integers(0, c, n, dtype=np.int32)).cuda(), thresholds]
    moved = n * c * 4 + n * 4 + 4 * t + 4 * (2 * c * t + 2 * c)
    res["binned_counts_labels[multiclass]"] = row = {
        "shape": [n, c, t],
        "ms": time_ms(lambda: binned_counts_labels(*largs), flush=flush),
        "plain_ms": time_ms(lambda: binned_counts_labels_plain(*largs), reps=5, flush=flush) if plain else None,
        **bound(moved, n * c * math.ceil(math.log2(t + 1))),
        "library_ms": None,
    }
    if plain:
        held("binned_counts_labels[multiclass]", row, binned_counts_labels(*largs),
             binned_counts_labels_plain(*largs), True)

    # the float64 instantiation: binary scores of 8 bytes with float64 thresholds
    n = BIN_N
    preds64, grid64 = float64_near_grid(rng, (n, 1), t)
    args64 = [torch.from_numpy(preds64).cuda(), torch.from_numpy(rng.integers(0, 2, (n, 1), dtype=np.int32)).cuda(),
              torch.ones((n, 1), dtype=torch.bool, device="cuda"), torch.from_numpy(grid64).cuda()]
    moved = n * (8 + 4 + 1) + 8 * t + 4 * (2 * t + 2)
    res["binned_counts_f64[binary]"] = row = {
        "shape": [n, 1, t],
        "ms": time_ms(lambda: binned_counts(*args64), flush=flush),
        "plain_ms": time_ms(lambda: binned_counts_plain(*args64), reps=5, flush=flush) if plain else None,
        **bound(moved, n * math.ceil(math.log2(t + 1))),
        "library_ms": None,
    }
    if plain:
        held("binned_counts_f64[binary]", row, binned_counts(*args64), binned_counts_plain(*args64), True)

    b, ch, h, w = SSIM_SHAPE
    k = _gaussian_taps_np(11, 1.5)
    planes = 5 * b * ch
    x = torch.from_numpy(rng.random((planes, h + 10, w + 10), dtype=np.float32)).cuda()
    moved = 4 * planes * ((h + 10) * (w + 10) + h * w)
    ops = 2 * planes * (11 * h * (w + 10) + 11 * h * w)
    row = {"shape": [planes, h + 10, w + 10, 11, 11], "ms": time_ms(lambda: ssim_window(x, k, k), flush=flush),
           "plain_ms": None, **bound(moved, ops), "library_ms": None}
    if plain:
        weight = torch.from_numpy(np.outer(k, k).astype(np.float32)).reshape(1, 1, 11, 11).cuda()
        x4 = x.unsqueeze(1)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        row["plain_ms"] = time_ms(lambda: ssim_window_plain(x, k, k), reps=5, flush=flush)
        held("ssim_window", row, ssim_window(x, k, k), ssim_window_plain(x, k, k), False)
        row["library_ms"] = time_ms(lambda: F.conv2d(x4, weight), reps=10, flush=flush)
        row["library_max_abs_err_vs_plain"] = float((F.conv2d(x4, weight)[:, 0] - ssim_window_plain(x, k, k))
                                                    .abs().max())
    res["ssim_window"] = row

    # B2 at the DIV2K first scale: the 15 planes (5 moments x 3 channels) of one 1356 x 2040 image, padded
    (h, w), planes = DIV2K_SHAPE, 15
    x = torch.from_numpy(rng.random((planes, h + 10, w + 10), dtype=np.float32)).cuda()
    moved = 4 * planes * ((h + 10) * (w + 10) + h * w)
    ops = 2 * planes * (11 * h * (w + 10) + 11 * h * w)
    row = {"shape": [planes, h + 10, w + 10, 11, 11], "ms": time_ms(lambda: ssim_window(x, k, k), flush=flush),
           "plain_ms": None, **bound(moved, ops), "library_ms": None}
    if plain:
        weight = torch.from_numpy(np.outer(k, k).astype(np.float32)).reshape(1, 1, 11, 11).cuda()
        x4 = x.unsqueeze(1)
        torch.backends.cudnn.allow_tf32 = False
        row["plain_ms"] = time_ms(lambda: ssim_window_plain(x, k, k), reps=5, flush=flush)
        held("ssim_window[div2k]", row, ssim_window(x, k, k), ssim_window_plain(x, k, k), False)
        row["library_ms"] = time_ms(lambda: F.conv2d(x4, weight), reps=10, flush=flush)
        row["library_max_abs_err_vs_plain"] = float((F.conv2d(x4, weight)[:, 0] - ssim_window_plain(x, k, k))
                                                    .abs().max())
    res["ssim_window[div2k]"] = row

    # B2 at the fleet's SSIM bucket: 512 sessions x 15 moment planes, 266 x 266 -> 256 x 256, one launch a tick
    planes, (h, w) = SSIM_SESSIONS * 15, SSIM_FLEET_SHAPE[2:]
    x = torch.from_numpy(rng.random((planes, h + 10, w + 10), dtype=np.float32)).cuda()
    moved = 4 * planes * ((h + 10) * (w + 10) + h * w)
    ops = 2 * planes * (11 * h * (w + 10) + 11 * h * w)
    row = {"shape": [planes, h + 10, w + 10, 11, 11], "ms": time_ms(lambda: ssim_window(x, k, k), flush=flush),
           "plain_ms": None, **bound(moved, ops), "library_ms": None}
    if plain:
        weight = torch.from_numpy(np.outer(k, k).astype(np.float32)).reshape(1, 1, 11, 11).cuda()
        x4 = x.unsqueeze(1)
        torch.backends.cudnn.allow_tf32 = False
        row["plain_ms"] = time_ms(lambda: ssim_window_plain(x, k, k), reps=5, flush=flush)
        held("ssim_window[fleet_ssim]", row, ssim_window(x, k, k), ssim_window_plain(x, k, k), False)
        row["library_ms"] = time_ms(lambda: F.conv2d(x4, weight), reps=10, flush=flush)
    res["ssim_window[fleet_ssim]"] = row
    del x

    # B2 at the new windows: VIF's 17-tap gaussian (sigma 3.4) over the LIVE path's scale-0 statistics (1,000
    # planes of 512 x 768, VALID), and the 8-tap uniform window over SCC's statistics at WorldView-3 reduced
    # resolution (800 planes of 256 x 256, padded to 263 x 263)
    windows = [("ssim_window[gauss17]", 5 * LIVE_PAIRS, LIVE_SHAPE, _gaussian_taps_np(17, 3.4)),
               ("ssim_window[uniform8]", 5 * WV3_IMAGES * WV3_BANDS, (263, 263), np.full(8, 0.125, dtype=np.float32))]
    for key, planes, (hp, wp), taps in windows:
        n = len(taps)
        h, w = hp - n + 1, wp - n + 1
        x = torch.from_numpy(rng.random((planes, hp, wp), dtype=np.float32)).cuda()
        moved = 4 * planes * (hp * wp + h * w)
        ops = 2 * planes * (n * h * wp + n * h * w)
        row = {"shape": [planes, hp, wp, n, n], "ms": time_ms(lambda: ssim_window(x, taps, taps), flush=flush),
               "plain_ms": None, **bound(moved, ops), "library_ms": None}
        if plain:
            weight = torch.from_numpy(np.outer(taps, taps).astype(np.float32)).reshape(1, 1, n, n).cuda()
            x4 = x.unsqueeze(1)
            torch.backends.cudnn.allow_tf32 = False
            row["plain_ms"] = time_ms(lambda: ssim_window_plain(x, taps, taps), reps=5, flush=flush)
            held(key, row, ssim_window(x, taps, taps), ssim_window_plain(x, taps, taps), False)
            row["library_ms"] = time_ms(lambda: F.conv2d(x4, weight), reps=10, flush=flush)
            row["library_max_abs_err_vs_plain"] = float((F.conv2d(x4, weight)[:, 0] - ssim_window_plain(x, taps, taps))
                                                        .abs().max())
        res[key] = row
        del x
    return res


def measure_ms_ssim(seed: int) -> dict:
    """One MS-SSIM update of a DIV2K pair, whole and scale by scale (each SSIM pass with its window launch,
    each pooling), with CUDA events around the host's launches, so that launch-bound small scales show; and
    the window kernel alone at each scale's planes (cold L2)."""
    from metrics_tpu_torch.functional.image._helpers import avg_pool2d
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np, _multiscale_ssim_update, _ssim_update
    from metrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
    from metrics_tpu_torch.ops.profile import flush_buffer, time_ms
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    preds, target = div2k_pair(_generator(seed + 12))
    metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cuda")
    metric.update(preds, target)  # first use of every operator
    res = {"update_ms": _event_ms(lambda: metric.update(preds, target), reps=5),
           "function_ms": _event_ms(lambda: _multiscale_ssim_update(preds, target, data_range=1.0), reps=5)}
    taps, flush = _gaussian_taps_np(11, 1.5), flush_buffer()
    scales, p, t = [], preds, target
    for s in range(MS_SSIM_SCALES):
        planes = torch.rand((15, p.shape[2] + 10, p.shape[3] + 10), device="cuda")
        scale = {"shape": list(p.shape[2:]),
                 "ssim_pass_ms": _event_ms(lambda: _ssim_update(p, t, data_range=1.0,
                                                                return_contrast_sensitivity=True), reps=5),
                 "window_kernel_ms": time_ms(lambda: ssim_window(planes, taps, taps), flush=flush)}
        if s < MS_SSIM_SCALES - 1:
            scale["pool_ms"] = _event_ms(lambda: (avg_pool2d(p, 2), avg_pool2d(t, 2)), reps=5)
            p, t = avg_pool2d(p, 2), avg_pool2d(t, 2)
        scales.append(scale)
    res["scales"] = scales
    return res


def measure_baseline(directory: str, seed: int) -> dict:
    """The older tree's own ``measure`` (its kernels only), in a process started in ``directory``."""
    code = ("import json, sys, numpy as np, chip_smoke; from metrics_tpu_torch.ops import _native; _native.build();"
            f" res = chip_smoke.measure(np.random.default_rng({seed}));"
            " print('BASELINE ' + json.dumps({k: v['ms'] for k, v in res.items()}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=directory, capture_output=True, text=True, timeout=600,
                          env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("BASELINE ")]
    if proc.returncode != 0 or not lines:
        fail(f"baseline measurement in {directory} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("BASELINE "):])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--baseline", default=None,
                        help="an unpacked older tree of this repository whose kernels are timed in turns with these")
    opts = parser.parse_args()
    seed = opts.seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops import _native
    from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_labels
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    t_script = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({torch.cuda.device_count()} visible); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _native.build(_native.KERNEL_SOURCES + _native.HOST_SOURCES, ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    log(f"built {len(_native.KERNEL_SOURCES)} kernel libraries and the RLE codec in {build_s:.1f} s")
    for name, text in _native.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas[{name}]: {line.strip()}")

    rng = np.random.default_rng(seed)
    log(f"phase 3, largest |kernel - plain| over the edge cases and shapes: {json.dumps(check_kernels(rng))}")

    wrappers = {"binned_counts": binned_counts, "binned_counts_labels": binned_counts_labels,
                "ssim_window": ssim_window}
    t0 = time.perf_counter()
    path = main_path(seed, wrappers)
    log(f"main path in {time.perf_counter() - t0:.1f} s: {json.dumps(path)}")
    log(f"counted apart from the main path: {json.dumps(APART)}")
    log(f"main path's parts, wall seconds: {json.dumps(SECTION_S)}")
    expect = {"BinaryPrecisionRecallCurve": {"binned_counts": PRC_STEPS},
              "MulticlassPrecisionRecallCurve": {"binned_counts_labels": PRC_STEPS},
              "StructuralSimilarityIndexMeasure": {"ssim_window": SSIM_STEPS},
              "MultilabelAveragePrecision": {"binned_counts": PRC_STEPS},
              "BinaryAUROC": {"binned_counts": PRC_STEPS},
              "MulticlassAUROC": {"binned_counts_labels": PRC_STEPS},
              "BinaryAUROC[exact,max_fpr=0.5]": {}}
    for metric in path:
        task = metric.rsplit("[", 1)[-1].rstrip("]")
        if "expected_launches" in path[metric]:
            expect[metric] = path[metric]["expected_launches"]
        elif task in ("binary", "multilabel"):
            expect[metric] = {"binned_counts": 1}
        elif task == "multiclass":
            expect[metric] = {"binned_counts_labels": 1}
    for metric, want in expect.items():
        got = {k: v for k, v in path[metric]["launches"].items() if v}
        if got != want:
            fail(f"{metric} launched {got}, expected {want}")
    launches = {name: sum(run["launches"][name] for run in path.values()) for name in wrappers}
    log(f"kernel launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            fail(f"the main path never launched {name}")

    old = []
    if opts.baseline:
        old.append(measure_baseline(opts.baseline, seed))
    timing = measure(rng)
    if opts.baseline:
        again = measure(rng, plain=False)
        old.append(measure_baseline(opts.baseline, seed))
        for key, row in timing.items():
            row["ms_runs"] = [row["ms"], again[key]["ms"]]
            row["baseline_ms_runs"] = [run[key] for run in old if key in run]
    for name, row in timing.items():
        log(f"{name}: {json.dumps(row)}")
    log(f"MS-SSIM update of one DIV2K pair: {json.dumps(measure_ms_ssim(seed))}")
    log(f"VIF's window launches at the LIVE size, by scale: {json.dumps(measure_vif_scales(seed))}")

    sources = {"binned_counts[binary]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                         "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts[multiclass]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                             "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts[multilabel]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                             "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts_labels[multiclass]": ("binned_counts_labels", "metrics_tpu_torch/csrc/binned_hist.cu",
                                                    "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts_f64[binary]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                             "metrics_tpu/ops/binned_hist.py:151"),
               "ssim_window": ("ssim_window", "metrics_tpu_torch/csrc/ssim_window.cu",
                               "metrics_tpu/ops/ssim_window.py:60"),
               "ssim_window[div2k]": ("ssim_window", "metrics_tpu_torch/csrc/ssim_window.cu",
                                      "metrics_tpu/ops/ssim_window.py:60"),
               "ssim_window[gauss17]": ("ssim_window", "metrics_tpu_torch/csrc/ssim_window.cu",
                                        "metrics_tpu/ops/ssim_window.py:60"),
               "ssim_window[uniform8]": ("ssim_window", "metrics_tpu_torch/csrc/ssim_window.cu",
                                         "metrics_tpu/ops/ssim_window.py:60"),
               "binned_counts[fleet_binary]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                               "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts[served_binary]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                                "metrics_tpu/ops/binned_hist.py:151"),
               "ssim_window[fleet_ssim]": ("ssim_window", "metrics_tpu_torch/csrc/ssim_window.cu",
                                           "metrics_tpu/ops/ssim_window.py:60")}
    fleet_launches = APART["fleet_engine"]["launches"]
    kernels = []
    for key, (name, source, replaces) in sources.items():
        row = timing[key]
        # the kernel against its plain version on this row's own inputs (phase 3 covers the edge cases)
        err = row["max_abs_err"]
        # the fleet rows' launches are the fleet_engine section's, counted apart from the main path's
        count = fleet_launches[name] if key.endswith(("[fleet_binary]", "[fleet_ssim]")) else launches[name]
        if key.endswith("[served_binary]"):  # the serve section's 1,000-stream ticks, counted apart
            count = APART["serve"]["launches_1000"][name]
        kernels.append({
            "name": key, "route": "cuda", "source": source, "replaces": replaces, "launches": count,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })

    log(f"whole run in {time.perf_counter() - t_script:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
