#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lidar_layout_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase, as the acceptance run
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,kernels,train_slice,train
    python3 chip_smoke.py --phases device,build,kernels,eval_slice,eval
    python3 chip_smoke.py --phases device,build,kernels,layout_slice,layout
    python3 chip_smoke.py --phases device,build,kernels,layout_train_slice,layout_train
    python3 chip_smoke.py --phases device,build,kernels,layout_boxes_slice,layout_boxes
    python3 chip_smoke.py --phases device,build,kernels,layout_boxes_train_slice,layout_boxes_train
    python3 chip_smoke.py --phases device,build,kernels,ae_train_slice,ae_train
    python3 chip_smoke.py --phases device,build,coarse_slice,coarse
    python3 chip_smoke.py --phases device,build,cube_slice,cube
    python3 chip_smoke.py --phases device,build,ae_train,ae_eval
    python3 chip_smoke.py --phases device,build,kernels,dense_slice,dense
    python3 chip_smoke.py --phases device,build,kernels,cond_slice,cond
    python3 chip_smoke.py --phases device,build,kernels,families_slice,families
    python3 chip_smoke.py --phases device,build,kernels,split_slice,split
    python3 chip_smoke.py --phases device,build,kernels,ae_train,ae_bf16_slice,ae_bf16,data
    python3 chip_smoke.py --phases device,build,zoo_slice,zoo,sonata,cond_train
    python3 chip_smoke.py --phases device,build,kernels,ddp
    python3 chip_smoke.py --phases device,build,kernels,sp

Phases (any failure exits non-zero before the final "ok" line):
  device       require CUDA, print the card's name and power limit, turn TF32 off
  build        compile every kernel in csrc/ with nvcc (in parallel; flash_attn_fwd
               in seven parts, then linked), print ptxas
  kernels      each kernel vs its plain PyTorch version at the flagship shapes,
               float32 and bfloat16: K1 (and its log-sum-exp), K2, K3 (forward
               at every main-path shape, the cluster and two-sweep paths
               included; backward at every training shape, dgamma and dbeta bit
               for bit over two launches), and the gradients of the attention
               and GroupNorm Functions, with K1/K2 at the edges of their tiles
               (S = 1, 127, 129, 2049; D = 8, 96; a masked key tile) and at
               B*H = 70,000; K1 bit for bit over two launches, K2's dq, dk and dv
               bit for bit over two launches at every case; K4 (f32) against its
               plain version and float64, with masks, on clouds built to trip
               its candidate selection (near ties, duplicated y, x in y, a 1 cm
               grid, 500 m from the origin), bit for bit over two launches, its
               error model checked on the pairs it re-checks, and its grad guard;
               K3 also at every group shape of the layout path (the layout
               U-Net at batch 16 and, guided, 32; the nuScenes VQ decoder); K3's
               backward also at every layout training shape; K1 (with its
               log-sum-exp) and K2 at LayoutDiffusion's (256, 8, 1, 64) f32 on
               CrossAttention's strides, bit for bit over two launches, K2's dq
               and dk required to be exactly 0 (one key), as JAX's are; K3
               forward and backward in f32 at every group shape of the
               autoencoder's training step (encoder, decoder, discriminator);
               K1 and K2 at the coarse LiDM's S = 128, 32 and 8 (f32 and
               bf16, bit for bit over two launches) and K3 forward and
               backward at every group shape of the coarse paths; K1 and K2
               in f32 with key-padding biases (a ragged tail, a patch of
               padding alone) at every attention shape of the dense
               decoder's PT-v3, and K3 at the Gaussian AE's step shapes; K1
               in f32 at the conditional U-Net's shapes (batch 2 and 4, bit
               for bit over two launches), K3 in f32 at its and the VQ
               decode's group shapes, and forward and backward at the
               noisy-latent classifier's; K3 forward and backward in f32 at
               every group shape of an R2DM training step at batch 4 (widths
               64-1024, spans up to 768 KB; a request's U-Net eval has the
               forward's), both bit for bit over two launches (the KL AE has
               the kitti AE's group shapes)
  slice        full-width flagship, f32, batch 1, seeded weights: DDIM-4 + decode
               on the card (kernels) vs on the CPU (plain versions)
  train_slice  one full-width training step, f32, batch 1, on the card vs on the
               CPU: loss, U-Net gradients, parameters and EMA after AdamW
  main         GenerationPipeline at full width, batch 16, bf16: generate(32) with
               DPM-20 and with DDIM-50; checks outputs and the kernel launch counts
  split_slice  the tiny flagship served patched (split_ks (4, 16), stride (4, 8))
               in f32 on the card vs the CPU: apply_model over four crops, the
               patched encode and decode; launches against the structure
  split        the flagship at 64x2048 (latent 16x256, crops of 16x128 at a
               stride of 16x64) through GenerationPipeline, bf16, DPM-20,
               generate(8) at batch 4: samples/s, the phase split (the U-Net
               from a synchronised request), peak memory, K1 and K3 launches
               against crops x evals x blocks
  train        the training step at full width, batch 16, bf16 autocast, f32
               weights, synthetic scenes: steps/s, phase split, peak memory,
               launches per step against module hooks (the plain GroupNorm
               backward called no time), a fixed-batch overfit check
  eval_slice   the eval modules on the card vs on the CPU, same numpy clouds:
               CD (K4 vs plain, 2 pairs), EMD at N = 2048, BEV histograms and
               bitmaps, RangeNet features at 64x1024, FRID; MinkowskiNet and
               SPVCNN at the registry's full config on 8 clouds (the grid
               pyramid integer for integer, the descriptors of the first 2
               against the CPU's),
               and their device twin (make_voxel_descriptor_fn) against the
               host feature path (FSVD and FPVD)
  eval         the sample-and-evaluate path at full width: generate(32) with
               DPM-20 at batch 16, bf16; 32 synthetic references range-
               roundtripped on the card; CD, JSD, MMD, FRID, FSVD, FPVD, each
               metric's seconds; the voxel nets' inputs per cloud (points
               before and after the 30000 cap, the share past 1023 cells,
               voxels per pyramid level against capacity); launch counts; the
               device-side statistics of JSD, MMD and FRID against the host's
  layout_slice the full-width layout-conditioned model, f32, batch 2, seeded
               weights: layout encoding, DDIM-4 with cfg_scale 2.0 and decode on
               the card (K3) vs on the CPU (plain versions)
  layout       GenerationPipeline.from_config of the layout model at full width,
               bf16: 32 synthetic layouts encoded, generate(32) at batch 16 with
               DPM-20 and DDIM-50, each at cfg_scale 1.0 and 2.0 (the all-padding
               layout's encoding as uncond); samples/s, phase split, peak memory,
               K3 launches against the model's structure and module hooks (no
               other kernel), finite (32, 32, 1024, 1) images, and different
               images from different layouts
  layout_train_slice  train_slice's step for the full-width layout model, f32,
               batch 2, dropout off, at fixed t, noise and layout: loss, U-Net
               and layout-encoder gradients, parameters and EMA after AdamW
  layout_train the layout model's training step at batch 16, bf16 autocast, f32
               weights, synthetic nusc_layout_range batches: steps/s, phase split,
               peak memory, K3 forward and backward launches per step against the
               model's structure and module hooks (the plain GroupNorm backward
               called no time), non-zero finite encoder gradients, an overfit check
  layout_boxes_slice  the full-width LayoutDiffusion (layout_nusc.yaml), f32,
               16 scenes x 16 objects, card vs CPU: the scene-graph encoder's two
               outputs, one U-Net eval, a DDIM-4 request from the same x_T
  layout_boxes sample_layout's path at 16 scenes x 16 objects, DDIM-100, f32:
               scenes/s and boxes/s over one request, K1 launches (22 a U-Net
               eval) against the structure and module hooks, no plain attention,
               finite (256, 7) boxes, different boxes from different graphs
  layout_boxes_train_slice  one LayoutDiffusion training step at full width,
               f32, 16 scenes x 16 objects, card vs CPU, at fixed t, noise and
               change noise, dropout off: loss, U-Net1D and scene-graph encoder
               gradients (relative L2 over each), parameters and EMA after
               AdamW, to_q/to_k gradients exactly 0
  layout_boxes_train  train_layout's step at 16 scenes x 16 objects, f32:
               synthetic graphs and one batch read from a tiny infos pickle;
               steps/s, scenes/s, phase split, peak memory, K1 and K2 launches
               per step (22 each) against the structure and module hooks, no
               plain attention, non-zero finite encoder gradients, an overfit
               check; then the train_layout CLI (--synthetic --steps 1) and
               sample_layout -r on its run directory
  ae_train_slice  one VQ-GAN step of the full-width kitti autoencoder
               (configs/autoencoder/kitti/autoencoder_c2_p4.yaml), batch 4, f32,
               TF32 off, card vs CPU from the same weights at step 0 (GAN terms
               on; coarse_slice holds step 2, GAN terms off, under the same
               gates): every loss part, d_weight, disc_loss, both
               models' gradients (relative L2) and parameters after Adam; K3
               launches against the structure and module hooks; at step 0 a
               TF32-on control that the same gates must reject
  ae_train     the autoencoder's training step at batch 4, f32: steps/s,
               samples/s, the split into generator (with the adaptive weight),
               discriminator and both Adams, peak memory, K3 forward and
               backward launches (52 + 52 in the autoencoder, 9 + 12 in the
               discriminator) against the structure and hooks, no plain
               GroupNorm, a falling rec_loss on one batch; then train_lidm
               --synthetic --steps 2 on the kitti and nuScenes AE YAMLs, and the
               kitti run's checkpoint as the flagship LiDM's first stage
  ae_bf16_slice  one step of the kitti AE with the perceptual loss and linear
               attention on 32x256 images: f32 on the card vs the CPU, then bf16
               (autocast, JAX's dtype policy) vs f32 on the card; K3 launches
  ae_bf16      the kitti AE as train_lidm --bf16 trains it with the perceptual
               loss (random RangeNet-21), full width, batch 4: steps/s, peak
               memory, the perceptual net's share of a step, K3 launches a step,
               a falling rec_loss over the timed steps
  data         scans written as KITTI-360 files read through the native loader
               (native/lidar_io.cpp built by g++) and the Python reader: equal
               batches, the native path taken; device_synthetic's scenes on the
               card: valid fraction, depth percentiles
  coarse_slice "Ours" stage 1 card against CPU at full width, f32, TF32 off:
               the coarse AE's VQ-GAN step (range_256x8.yaml, batch 4) at
               steps 0 and 2 under ae_train_slice's gates; the coarse LiDM's
               apply_model, DDIM-3 + decode and one training step, batch 4
  coarse       the coarse LiDM (range_uncond_diffusion_64x4.yaml) served by
               from_config in bf16, generate(32) at batch 16, DPM-20 and
               DDIM-50, the geometry from the YAML; its training step at
               batch 16 (bf16 autocast); the coarse AE's at batch 4,
               accumulate 2, f32; K1, K2, K3 launches against the structure
               and hooks; train_lidm on range_256x8.yaml, range_flow.yaml and
               the LiDM over the AE run's checkpoint
  cube_slice   "Ours" stage 2 card against CPU at voxel_1024.yaml's full
               config, 2 clouds of 32,768 points, f32: grids, targets and
               point-to-voxel maps integer for integer, latents, logits,
               struct_loss and gradients; CubeDiffusion's p_losses, U-Net
               gradients and a DDIM-5 from fed draws
  cube         train_lidm on voxel_1024.yaml (5 steps, batch 4), on
               voxel_uncond_diffusion_256.yaml over that run (5 steps) and
               on autoencoder_cube.yaml (2 steps); timed steps, the level
               fill per cloud, a DDIM-50 over the 4 encoded grids; no kernel
  dense_slice  "Ours" stage 3 card against CPU, f32, TF32 off: the dense
               decoder (gaus_10cm.yaml) at 8192 points, PT-v3's integers
               equal (grids, curve orders, pooled segments), its features
               and the surfels within 1e-5, the banded render; at 1024
               points the dense and surfel renders, gs_loss and one
               train_dense_decoder step (gradients within 1e-4); the
               Gaussian AE's s2 step at step 0 (GAN terms on) under
               ae_train_slice's gates (32x256 images)
  dense        the dense decoder's decode of 8192-point clouds (clouds/s,
               PT-v3 / raster split, K1 22 a decode), the train_dense_decoder
               CLI and 5 timed steps (K1 + K2 22 + 22 a step, the phase
               split, device against wall time, an overfit check), a
               dead-decoder check at the YAML's lr, the valid rows of every
               PT-v3 level; the Gaussian AE at batch 4,
               accumulate 2 (K3 launches against the structure and hooks)
               and train_lidm on its YAML
  cond_slice   conditional generation card against CPU, f32, TF32 off, at small
               widths: a SpatialTransformer with a context mask, the three
               conditioning stages (SpatialRescaler, the multi-view CLIP image
               and text wrappers over 2-layer towers), one U-Net eval under
               each of concat, crossattn, hybrid and adm, the classifier's
               loss and guidance_grad (relative L2 within 1e-5)
  cond         the three CLIs' main() at full width, f32, DDIM-25: sample_cond
               map2lidar and cam2lidar (4 samples) and text2lidar (2 samples,
               cfg_scale 2.0): the .npy of the JAX scripts' names and shapes,
               K1 and K3 launches against the structure (and hooks), peak
               memory; then timed requests with a seeded U-Net (seconds a
               request, samples/s) and checks that the conditioning moves
               the images (rolled conditions; cfg_scale 1.0 against 2.0)
  families_slice  the last families card against CPU, f32, TF32 off, at small
               widths: an R2DM U-Net eval for each coordinate encoding,
               p_losses with fed t and noise, one R2DM step (loss, gradients,
               parameters and EMA after AdamW), the object AE's
               reconstruction and one step, knn_query's indices on a lattice
               cloud full of ties (equal), one KL-AE step (relative L2 within
               1e-5, gradients within 1e-4, parameters and EMA after the
               update within 2 lr)
  families     r2dm_diffusion.yaml, g2sd_32.yaml and the KL override of the
               kitti AE's YAML through train_lidm on the card; 5 timed steps
               of each (steps/s, peak memory, K3 launches against the
               structure and hooks: 61 + 61 a step for R2DM, none for the
               object AE), an overfit check on one batch; two R2DM DDIM-50
               requests of 4 samples on seeded weights, then range2pcd
               (samples/s, peak memory, 52 x 61 K3 launches a request); and
               run_tester with ReconTester on the kitti AE
  zoo_slice    the point-backbone zoo card against CPU at the CPU tests' tiny
               configs, f32, TF32 off: the six segmentation backbones' logits
               and parameter gradients, Sonata's loss, center and gradients
               from fixed seeds (relative L2 within 1e-4), cluster_points'
               labels (equal); no kernel launched by the backbones
  zoo          the six backbones at their reference widths (the ctor defaults;
               OctFormer's and Swin3D's voxel tables raised to the cloud) on a
               synthetic scene of 32,768 rows, 1024 of them padding: one
               forward and one backward of a cross-entropy, f32; seconds, peak
               memory, finite logits and gradients, padding rows 0, no kernel
  sonata       K1 and K2 in f32 with key biases at PT-v3's default shapes
               (head dim 16) on 32,768 rows; Sonata's pre-training step with
               the reference head (4096 hidden, 512 embed, 4096 prototypes),
               2 warm-ups and 5 timed steps with AdamW: steps/s, peak memory,
               K1 44 and K2 22 a step against the structure and hooks, a
               finite loss, the teacher and the center moving
  cond_train   the flagship LiDM made crossattn over a trainable x-transformers
               BERT (640 wide, 32 layers, 77 tokens; 2 warm-ups, 5 timed
               steps) and map2lidar (c_concat, as sample_cond builds it; 3
               timed steps), batch 4, f32: K2 in f32 at head dim 32 at the
               three attention shapes and K3 forward and backward at every
               group shape against their plain versions; steps/s, peak memory,
               K1, K2 and K3 launches against the structure and hooks, the
               trained set and EMA, the BERT's gradients non-zero and finite
  ddp          parallel/ on torch.distributed, the ranks started as torchrun
               starts them: (a) train_lidm on the flagship YAML at full width,
               --synthetic --bf16, global batch 16, 2 steps, through NCCL at
               world = card count: one copy of the run's files (rank 0's), the
               parameters against a one-process train_lidm run (cuDNN's
               deterministic algorithms in both), timed steps a rank against
               the one-process steps, launches a step against the structure,
               the all-reduce's time, and one FSDP step (fully_shard_module)
               against the plain step; (b) the rehearsal, two ranks sharing
               one card over gloo: one bf16 step at global batch 16, 8 a
               rank, replicas bit-equal, against the one-process step; each
               rank's launches against the structure; dp-sharded DPM-20
               generate(16) gathered through the host against one process's;
               the dry run (parallel.dryrun) in (a)'s ranks (its DDIM against
               one process's); with more than one card, K1-K4 on the last card
               while card 0 is current
  sp           the spatial axis of parallel/: the full-width flagship (f32, TF32
               off, the tests' seeded weights) W-sharded over 4 ranks sharing
               one card over gloo (NCCL at world = card count with 4 cards or
               more, sp as JAX's rule gives): the sharded first-stage encode
               of a (2, 64, 1024, 1) image and apply_model at t = T/2,
               gathered, against one process's unsharded forward at rtol =
               atol = 2e-4; each rank's cross-length K1 and split K3 launches
               against the structure (one a SelfAttentionBlock, one a
               Normalize) and its hooks, no other kernel; then the cross-length
               K1 (f32 and bf16) and the split K3's two kernels at every sp
               shape against their plain versions, bit for bit over two
               launches, and the split K3 merged over the shards against K3's
               plain version on the whole width
  ae_eval      eval_ae on the ae_train phase's kitti run: 4 batches of 4,
               CD through K4 and JSD, launches against the structure
  timing       per-kernel device times at the main paths' shapes beside the
               plain version, one PyTorch library call and the card's bound,
               and for K1/K2 the special-function unit's floor for their
               exponentials; K3 also summed by shape class, and its backward a
               training step (K4 at the eval's clouds, so it needs the eval
               phase); K3 also at the guided layout request's shapes, summed
               over the guided layout run; K1 at LayoutDiffusion's (256, 8, 1, 64) f32,
               summed over a request (its launches counted by hooks on one
               request when layout_boxes did not run); K3's backward at the
               layout model's training shapes, summed over its timed steps;
               K1 (with its log-sum-exp) and K2 at (256, 8, 1, 64) f32 beside
               SDPA's forward and backward, summed over LayoutDiffusion's 10
               timed training steps; K3 forward and backward in f32 at the
               autoencoder step's shapes, summed over ae_train's 5 timed steps;
               K1/K2/K3 at the coarse paths' shapes, summed over their runs;
               K1 and K2 in f32 with a key bias at the dense decoder's
               shapes, over its decodes and timed steps; K3 at the Gaussian
               AE's step shapes; K1 and K3 in f32 at the conditional path's
               shapes over a map2lidar and a cam2lidar request ("cond"); K3
               forward and backward in f32 at R2DM's shapes over a DDIM-50
               request and over its 5 timed training steps; K4 at eval_ae's
               16 pairs (ae_eval's clouds); K1 and K3 in bf16 at the patched
               request's shapes over the split run; K3 forward and backward
               at the bf16 AE step's shapes (the autoencoder's in bf16, the
               discriminator's in f32) over ae_bf16's timed steps; K1 and K2
               in f32 with a key bias at Sonata's shapes over its timed
               steps; K1 and K2 in f32 at head dim 32 and K3 forward and
               backward at the crossattn LiDM's shapes over its; the
               cross-length K1 beside SDPA and the split K3's two kernels in
               f32 at the sp shapes, over one sharded encode and apply_model
               of a rank. K3 is
               timed on input copies taken in turn, more than twice the L2
               apart, so that each call reads from HBM as in a model; every
               kernel time that reads over 105% of its bound fails the phase
  profile_zoo  (only when named) profile's rows of the zoo (one forward and
               backward of each backbone), a Sonata step and both
               conditional LiDM training steps
  profile      (only when named) device time of one DPM-20 request, of one
               guided layout request, of one training step, of one layout
               training step, of one LayoutDiffusion request, of one
               LayoutDiffusion training step, of one autoencoder training
               step, of one coarse request, coarse LiDM and AE training step,
               one step of each cube trainer, one dense decode, one dense-
               decoder step, one Gaussian AE step and one request of each
               conditional CLI's model by kernel family

The weights are random, drawn from a seed (no trained checkpoint is used). It
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "slice", "train_slice", "main", "split_slice", "split",
          "train", "eval_slice", "eval", "layout_slice", "layout", "layout_train_slice",
          "layout_train", "layout_boxes_slice", "layout_boxes", "layout_boxes_train_slice",
          "layout_boxes_train", "ae_train_slice", "ae_train", "ae_bf16_slice", "ae_bf16",
          "data", "coarse_slice", "coarse", "cube_slice", "cube", "dense_slice", "dense",
          "cond_slice", "cond", "families_slice", "families", "zoo_slice", "zoo", "sonata",
          "cond_train", "ddp", "sp", "ae_eval", "timing")
EXTRA_PHASES = ("profile", "profile_zoo")   # run only when named in --phases
N_MAIN, BATCH = 32, 16      # the main path: generate(32) in batches of 16
# published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
TRAIN_BATCH, TRAIN_STEPS = 16, 5   # the training path: timed steps at batch 16
# the overfit checks: 20 steps (every curve had fallen below its step 0 by
# step 20 on the H100; 30 took longer than the smoke's time allows)
OVERFIT_STEPS, OVERFIT_LR = 20, 1e-4
# the dense decoder's overfit takes a second a step; its curve, the same to
# four digits from call to call through step 15, puts the mean of steps 11-15
# at 0.38 of step 0 (the mean of steps 26-30: 0.36-0.84)
DENSE_OVERFIT_STEPS = 15
LAYOUT_CFG_SCALE = 2.0   # the guided layout run: DPM-20, generate(32) at batch 16
# LayoutDiffusion serving: 16 scenes at the nuScenes layout dataset's capacity
# of 16 objects and 32 triples a scene (N = 256 boxes), DDIM-100, f32
BOX_SCENES, BOX_STEPS, BOX_CALLS = 16, 100, 1
BOX_LR = 1.6e-5   # layout_nusc.yaml's: base 1e-6 x 16 scenes
# the range VQ autoencoder (VQ-GAN) in f32 at its YAML's batch of 4; the
# flagship LiDM whose first stage it is loads the CLI run's checkpoint
AE_YAML = os.path.join(HERE, "configs", "autoencoder", "kitti", "autoencoder_c2_p4.yaml")
AE_NUSC_YAML = os.path.join(HERE, "configs", "autoencoder", "nuscenes", "autoencoder_c2_p4.yaml")
LIDM_YAML = os.path.join(HERE, "configs", "lidar_diffusion", "kitti", "uncond_c2_p4.yaml")
AE_BATCH, AE_LR = 4, 1.8e-5   # the YAML's batch, and its lr: base 4.5e-6 x batch 4
# "Ours" stage 1, the coarse 8x256 range stage: its VQ autoencoder (f32, the
# YAML's batch 4 with accumulate 2) and its LiDM (U-Net 128 wide over a
# 4x32x8 latent; served and trained at batch 16 in bf16); range_flow.yaml,
# the 32x1024 nuScenes AE, through the CLI
OURS = os.path.join(HERE, "configs", "ours", "nuscenes")
COARSE_AE_YAML = os.path.join(OURS, "coarse_range", "range_256x8.yaml")
COARSE_LDM_YAML = os.path.join(OURS, "coarse_range", "range_uncond_diffusion_64x4.yaml")
RANGE_FLOW_YAML = os.path.join(HERE, "configs", "autoencoder", "nuscenes", "range_flow.yaml")
COARSE_LR = 1.6e-5   # the LiDM YAML's: base 1e-6 x batch 16
# "Ours" stage 2, the cube stage: the sparse-voxel VAE at 0.1 m (levels of
# 8192, 4096 and 2048 rows) and the latent diffusion over its grids, at the
# YAMLs' batch of 4 clouds of 32,768 points (the factory's max_points)
VOXEL_YAML = os.path.join(OURS, "refine_voxel", "voxel_1024.yaml")
VOXEL_LDM_YAML = os.path.join(OURS, "refine_voxel", "voxel_uncond_diffusion_256.yaml")
CUBE_AE_YAML = os.path.join(HERE, "configs", "autoencoder", "nuscenes", "autoencoder_cube.yaml")
CUBE_BATCH, CUBE_POINTS, CUBE_DDIM = 4, 32768, 50
# "Ours" stage 3, the dense decoder (gaus_10cm.yaml: PT-v3 32-512 wide,
# patch 1024, over one synthetic cloud of 8192 points a step, the CLI's
# --n-points; Gaussian surfels rendered at 32x1024 through RasterConfig
# chunk 512, the CLI's), f32; card against CPU at 1024 points for the
# rasterizers and the step. The Gaussian range AE at its YAML's batch 4,
# accumulate 2, f32; card against CPU on 32x256 images
DENSE_YAML = os.path.join(OURS, "dense_decoder", "gaus_10cm.yaml")
GAUS_AE_YAML = os.path.join(HERE, "configs", "autoencoder", "nuscenes",
                            "autoencoder_c2_p4_gaus.yaml")
DENSE_POINTS, DENSE_SLICE_POINTS, DECODE_CLOUDS = 8192, 1024, 5
GAUS_SLICE = ("data.params.dataset.size=[32,256]",)
GAUS_STEPS = 2   # the Gaussian AE's timed steps (3.4 s each)
# the dead-decoder check at the YAML's lr: steps logged, steps gated, and
# the least share of pixels with alpha > 1e-3 it holds before the first
# step and after each gated one (the card read 1, 0.994 and 0.708, then 0
# from step 3: both packages' decoders collapse at this lr)
DENSE_LIVE_STEPS, DENSE_LIVE_GATED, DENSE_LIVE_SHARE = 4, 2, 0.5
# conditional generation: the CLIs (sample_cond map2lidar / cam2lidar, 4
# samples; text2lidar, 2 samples under guidance) at full width, f32, DDIM-25;
# card against CPU at small widths within COND_SLICE_TOL relative L2
COND_STEPS, COND_CFG_SCALE, COND_SLICE_TOL = 25, 2.0, 1e-5
# the last families of train_lidm: R2DM (r2dm_diffusion.yaml, 2-channel
# 32x1024 pixel-space diffusion) trained at its YAML's batch of 4 and served
# by DDIM-50 requests of 4 samples; the G2SD object AE (g2sd_32.yaml, 1024-
# point synthetic objects, batch 4); the KL autoencoder, which no YAML names,
# on the kitti AE's YAML with the override JAX's CLI takes; all f32. Card
# against CPU at small widths within FAMILIES_SLICE_TOL relative L2 (the
# gradients within FAMILIES_GRAD_TOL, the tests' tolerance for gradients;
# the parameters after a step as the other training slices hold them)
R2DM_YAML = os.path.join(HERE, "configs", "r2dm", "r2dm_diffusion.yaml")
G2SD_YAML = os.path.join(HERE, "configs", "autoencoder", "nuscenes_objects", "g2sd_32.yaml")
KL_OVERRIDES = ("model.target=autoencoder_kl", "model.params.ddconfig.double_z=true")
R2DM_BATCH, R2DM_STEPS, R2DM_DDIM, R2DM_REQUESTS, R2DM_SAMPLES = 4, 5, 50, 1, 4
FAMILY_STEPS = 5   # the object and KL AEs' timed steps
FAMILIES_SLICE_TOL, FAMILIES_GRAD_TOL = 1e-5, 1e-4
# patched (split_ks) serving: the flagship at 64x2048, twice its training
# azimuth, its 16x256 latent in crops of 16x128 at a stride of 16x64 (4 a
# row, the last wrapping), DPM-20, bf16, generate(SPLIT_N) at batch SPLIT_BATCH;
# card against CPU on the tiny flagship at JAX's test setting, within
# SPLIT_SLICE_TOL of the largest magnitude (f32, TF32 off)
SPLIT_BATCH, SPLIT_N, SPLIT_SLICE_TOL = 4, 8, 1e-4
SPLIT_CROPS = 4   # 256 latent columns at a stride of 64
# the kitti AE in bf16 (train_lidm --bf16) with the RangeNet perceptual loss
# on random weights: timed at full width, batch 4; the slice adds linear
# attention, card against CPU in f32 on 32x256 images (CPU time), then the
# card's bf16 step against its f32 step, within AE_BF16_TOL relative on the
# well-conditioned logs (bf16 keeps 8 significant bits over ~20 layers each
# way) and AE_BF16_ILL_TOL on those that cancel or threshold
AE_BF16_OVERRIDES = ("model.params.lossconfig.params.perceptual_factor=1.0",)
AE_BF16_SLICE = AE_BF16_OVERRIDES + ("model.params.ddconfig.attn_type=linear",
                                     "data.params.dataset.size=[32,256]")
AE_BF16_STEPS = 5
AE_BF16_TOL, AE_BF16_ILL_TOL = 2e-2, 0.5
AE_BF16_ILL = ("d_weight", "smooth_loss", "normal_loss", "total_loss")
# the slice's bf16 gradients against the card's f32 ones, relative L2: the
# discriminator's with every term on; the generator's with the GAN,
# smoothness and normal terms off and the pixel loss squared
# (AE_BF16_SMOOTH), where rounding does not swamp them; a zero gradient
# reads 1.0 and a random one of the right norm about 1.41
AE_BF16_SMOOTH = ("model.params.lossconfig.params.smooth_factor=0",
                  "model.params.lossconfig.params.norm_factor=0",
                  "model.params.lossconfig.params.pixel_loss=l2",
                  "model.params.lossconfig.params.disc_start=-1")
AE_BF16_DISC_GRAD_TOL, AE_BF16_GEN_GRAD_TOL = 0.05, 0.2
# the AE slice's f32 gates, card against CPU: RangeNet adds 40 convolutions
# to the ~60 layers the f32 AE slice holds (its gradients read 1.1e-4 there)
AE_PERC_LOG_TOL, AE_PERC_DWEIGHT_TOL, AE_PERC_GRAD_TOL = 1e-4, 1e-3, 1e-3
# the data phase: scans written as KITTI-360 velodyne files and read through
# the native loader, and device_synthetic's scenes on the card
DATA_SCANS, DATA_BATCH = 8, 4
# the point-backbone zoo (no TPU kernel in JAX: LayerNorm, matmuls, gathers):
# card against CPU at the CPU tests' tiny configs (tests/test_torch_zoo.py)
# within ZOO_SLICE_TOL relative L2; each segmentation backbone at its
# reference widths, one forward and backward on a synthetic scene of
# ZOO_POINTS rows (the cube stage's cloud size), ZOO_PAD of them padding
ZOO_SLICE_TOL = 1e-4
ZOO_POINTS, ZOO_PAD = 32768, 1024
ZOO_TINY = {  # name -> (module, class, config class, config, cloud)
    "ptv1_seg26": ("ptv1", "PointTransformerSeg", "PTv1Config", dict(
        in_channels=4, num_classes=5, blocks=(1,) * 5, planes=(8, 12, 16, 20, 24),
        strides=(1, 2, 2, 2, 2), nsamples=(4,) * 5, share_planes=4),
        dict(n=64, valid=56, in_ch=4, extent=None)),
    "ptv2m2": ("ptv2", "PointTransformerV2", "PTv2Config", dict(
        in_channels=4, num_classes=5, patch_embed_depth=1, patch_embed_channels=12,
        patch_embed_groups=3, patch_embed_neighbours=4, enc_depths=(1, 1),
        enc_channels=(24, 48), enc_groups=(6, 12), enc_neighbours=(4, 4), dec_depths=(1, 1),
        dec_channels=(12, 24), dec_groups=(3, 6), dec_neighbours=(4, 4),
        grid_sizes=(0.12, 0.24), pool_ratios=(0.5, 0.25)),
        dict(n=64, valid=48, in_ch=4, extent=None)),
    "spunet": ("spunet", "SpUNet", "SpUNetConfig", dict(
        in_channels=4, num_classes=5, base_channels=8, channels=(8, 16, 16, 8),
        layers=(1, 1, 1, 1), stem_kernel=3, voxel_size=0.2, capacity=256),
        dict(n=128, valid=100, in_ch=4, extent=6.0)),
    "stratified": ("stratified", "StratifiedTransformer", "StratifiedConfig", dict(
        in_channels=4, num_classes=5, channels=(8, 16, 16, 16), depths=(1, 1, 1, 1),
        num_heads=(2, 2, 2, 2), window_size=(0.8, 1.6, 3.2, 6.4),
        quant_size=(0.2, 0.4, 0.8, 1.6), k=4, kp_neighbors=4, kp_kernel_points=5,
        downsample_scale=4, n_windows=32, window_capacity=12, sample_capacity=4),
        dict(n=128, valid=100, in_ch=4, extent=4.0)),
    "swin3d": ("swin3d", "Swin3DUNet", "Swin3DConfig", dict(
        in_channels=6, num_classes=5, channels=(8, 16, 16, 16, 16), depths=(1,) * 5,
        num_heads=(2,) * 5, window_sizes=(3,) * 5, quant_size=2, base_grid_size=0.25, k=4,
        capacity=512, n_windows=32, window_capacity=12),
        dict(n=200, valid=170, in_ch=6, extent=6.0)),
    "octformer": ("octformer", "OctFormer", "OctFormerConfig", dict(
        in_channels=4, num_classes=5, fpn_channels=16, channels=(8, 16, 16, 16),
        num_blocks=(1,) * 4, num_heads=(2,) * 4, patch_size=8, dilation=2, stem_down=1,
        voxel_size=0.25, capacity=512, rpe_quant=4),
        dict(n=256, valid=220, in_ch=4, extent=8.0)),
}
_ZOO_CLOUD = dict(n=ZOO_POINTS, valid=ZOO_POINTS - ZOO_PAD, extent="scene")
ZOO_REFERENCE = {  # the ctor defaults, the widths of tests/test_zoo_reference_scale.py
    "stratified": ("stratified", "StratifiedTransformer", "StratifiedConfig",
                   dict(num_classes=13), {**_ZOO_CLOUD, "in_ch": 3}),
    "octformer": ("octformer", "OctFormer", "OctFormerConfig",
                  dict(num_classes=13, capacity=ZOO_POINTS), {**_ZOO_CLOUD, "in_ch": 4}),
    "swin3d": ("swin3d", "Swin3DUNet", "Swin3DConfig",
               dict(num_classes=13, capacity=ZOO_POINTS), {**_ZOO_CLOUD, "in_ch": 6}),
    "ptv1_seg50": ("ptv1", "PointTransformerSeg", "PTv1Config", dict(),
                   {**_ZOO_CLOUD, "in_ch": 6}),
    "ptv2m2": ("ptv2", "PointTransformerV2", "PTv2Config", dict(), {**_ZOO_CLOUD, "in_ch": 4}),
    "spunet": ("spunet", "SpUNet", "SpUNetConfig", dict(), {**_ZOO_CLOUD, "in_ch": 4}),
}
ZOO_NOTES = {"octformer": "ctor defaults, its voxel table raised from 8192 to the cloud's 32768 "
                          "rows",
             "swin3d": "ctor defaults, its voxel table raised from 8192 to the cloud's 32768 rows"}
# Sonata: the CPU test's config in zoo_slice; pre-training at PT-v3's default
# widths with the reference head (4096 hidden, 512 embed, 4096 prototypes) on
# one synthetic scene, AdamW at the reference's lr 0.004 and weight decay 0.04
SONATA_TINY_BB = dict(in_channels=4, patch_size=16, enc_depths=(1, 1), enc_channels=(8, 16),
                      enc_heads=(2, 2), dec_depths=(1,), dec_channels=(8,), dec_heads=(2,),
                      orders=("z", "hilbert"), grid_size=0.2)
SONATA_TINY = dict(head_in_channels=8, head_hidden_channels=16, head_embed_channels=8,
                   head_num_prototypes=32, total_steps=100)
SONATA_REFERENCE = dict(head_in_channels=64, head_hidden_channels=4096, head_embed_channels=512,
                        head_num_prototypes=4096)
SONATA_POINTS, SONATA_STEPS, SONATA_LR = 32768, 5, 4e-3
# conditional LiDM training, f32, batch 4: the flagship made crossattn over a
# trainable x-transformers BERT (JAX's _lidm_cfg wiring at full width), and
# map2lidar (c_concat); the YAML's lr (base 1e-6 x batch 4)
COND_TRAIN_BATCH, COND_TRAIN_STEPS, COND_CONCAT_STEPS, COND_TRAIN_LR = 4, 5, 3, 4e-6
COND_TRAIN_WORDS = ("a", "car", "on", "the", "wet", "road", "empty", "intersection", "heavy",
                    "traffic", "at", "night", "parked", "truck", "pedestrian", "crossing")
KERNELS = (  # name, source, the TPU kernel it replaces
    ("flash_attention", "lidar_layout_tpu_torch/csrc/flash_attn_fwd.cu",
     "lidar_layout_tpu/ops/pallas_attention.py:87"),
    ("flash_attention_xl", "lidar_layout_tpu_torch/csrc/flash_attn_fwd.cu",
     "lidar_layout_tpu/ops/pallas_attention.py:87"),
    ("group_norm_stats", "lidar_layout_tpu_torch/csrc/group_norm.cu",
     "lidar_layout_tpu/ops/pallas_groupnorm.py:135"),
    ("group_norm_apply", "lidar_layout_tpu_torch/csrc/group_norm.cu",
     "lidar_layout_tpu/ops/pallas_groupnorm.py:135"),
    ("flash_attention_bwd", "lidar_layout_tpu_torch/csrc/flash_attn_bwd.cu",
     "lidar_layout_tpu/ops/pallas_attention.py:205"),
    ("group_norm", "lidar_layout_tpu_torch/csrc/group_norm.cu",
     "lidar_layout_tpu/ops/pallas_groupnorm.py:135"),
    ("group_norm_bwd", "lidar_layout_tpu_torch/csrc/group_norm.cu",
     "lidar_layout_tpu/ops/pallas_groupnorm.py:183"),
    ("chamfer_nn", "lidar_layout_tpu_torch/csrc/chamfer_nn.cu",
     "lidar_layout_tpu/ops/pallas_chamfer.py:71"))
# K1 cases: the flagship's shapes, a fused qkv view, key padding, D = 16 to 128
ATTN_CASES = [((16, 8, 2048, 32), False, False), ((16, 16, 512, 32), False, False),
              ((16, 32, 128, 32), False, False), ((16, 8, 2048, 32), True, False),
              ((4, 8, 1000, 32), False, True), ((2, 4, 333, 64), True, True),
              ((2, 2, 200, 128), False, True), ((2, 2, 130, 16), True, False)]
SFU_EX2_PER_CLOCK = 16   # exp2 per clock per SM on Hopper (special-function unit)
# 32-bit floating-point compare, minimum, maximum per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput)
FMNMX_PER_CLOCK = 64
# emd holds an (N, N) matrix: checked at N = 2048, a multiple of 1024 (the
# CPU's auction took 3.4-16.3 s at 4096 on the H100 host)
EMD_N = 2048
EVAL_METRICS = ("cd", "jsd", "mmd", "frid", "fsvd", "fpvd")
# MinkowskiNet / SPVCNN descriptors, card against CPU at the registry's full
# config (f32, TF32 off; convolutions summed in other orders, scatter-means
# by atomics on the card): relative L2 over 8 clouds; the device twin (the
# same nets on the card, from range2pcd's points) against the host path
VOXEL_DESC_TOL = 1e-4
VOXEL_TWIN_TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
PROFILER_TRIES = 3   # profiler sessions a device_ms tries before it takes CUDA events
EVENT_TIMINGS = []   # what device_ms timed with CUDA events: no session saw the device
# FRID from the device twin's inputs (the decoded raster itself) against the
# host path's (reproject, then rasterise again): reprojected points sit on
# pixel-floor boundaries, so about a tenth of the valid pixels move to a
# neighbouring column by float-ulp noise, and the two FRIDs are of slightly
# different inputs. On the H100, with the seeded weights here, the twin reads
# 4.502e-02 and a faulty twin with its depth left in model space 6.408e-01;
# the limit sits between them. Rasters rolled by one row or one column read
# 4.508e-02 and 4.506e-02: random RangeNet features barely see such a shift,
# so they are logged, not gated (the twin's input function is held card
# against CPU in eval_slice and CPU against JAX in the tests)
FRID_TWIN_TOL = 0.05
FRID_FAULTS = ("depth in model space",)   # faulty twins beyond that limit


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def seed_weights(model, seed: int = 0):
    """The tests' seeded weights (tests/torch_port_helpers.py): every
    parameter at ~1/sqrt(fan_in), the zero-initialised output layers
    included, and an N(0, 1) codebook."""
    from torch_port_helpers import seed_weights as fill   # tests/ is on sys.path

    return fill(model, seed)


def unet_evals(model, steps: int) -> int:
    """U-Net evals of one request: the uniform DDIM table of the JAX package
    gives 21 timesteps for 20 steps and 52 for 50 over 1024 DDPM steps."""
    from lidar_layout_tpu_torch.models.schedules import DDIMSchedule

    return len(DDIMSchedule.create(model.schedule, steps).timesteps)


@functools.lru_cache(maxsize=None)
def sm_clocks_per_ms() -> float:
    """SM clocks a millisecond over the whole card: its SMs at its maximum SM
    clock (nvidia-smi)."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"clock for the floors: {sms} SMs x {mhz:g} MHz")
    return sms * mhz * 1e3


def sfu_ex2_per_ms() -> float:
    """Exponentials a millisecond on the special-function units: 16 exp2 a
    clock per SM."""
    return SFU_EX2_PER_CLOCK * sm_clocks_per_ms()


def path_name(k: int) -> str:
    """K3's path for a span: the blocks that hold it on chip, or the sweep."""
    return {0: "two-sweep", 1: "one block"}.get(k, f"cluster of {k}")


def max_err(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(b.float().abs().max())


# spin kernels around a profiler session's calls (torch.cuda._sleep): the
# leading ones (PAD_SPIN_CYCLES each, about 1 ms at 1980 MHz) let the host
# queue every call before the card reaches them, so the events between them
# time the calls back to back; a session that drops activities drops them at
# its ends, and the spins there take the loss
PAD_SPINS, PAD_SPIN_CYCLES = 4, 2_000_000


def session_window(events):
    """The (name, device us) of a session's activities between its last
    leading spin kernel (about 1 ms) and the first trailing one (about a
    microsecond) after it, from ``events`` (name, start us, device us); None
    when either is missing (the window cannot be told). Activities before
    the leading spins (another session's, delivered late) fall outside."""
    events = sorted(events, key=lambda e: e[1])
    lead = [i for i, e in enumerate(events) if "spin_kernel" in e[0] and e[2] >= 100]
    if not lead:
        return None
    trail = [i for i, e in enumerate(events) if i > lead[-1] and "spin_kernel" in e[0]]
    if not trail:
        return None
    return [(e[0], e[2]) for e in events[lead[-1] + 1:trail[0]]]


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call: the CUDA kernel (and copy) times
    that torch.profiler records over ``reps`` calls, summed. It traces the
    device only: a session that also traces the host took 52 ms against 26
    (NVIDIA H100 80GB HBM3, 700 W), and the timing phase opens about a
    thousand, for the same device times. Gaps between launches, where the
    card waits for the host, are not counted. The calls sit between spin
    kernels (PAD_SPINS) and CUDA events, and only the activities between the
    spins count (``session_window``). On some hosts sessions lose one to
    three activities, or hold activities of an earlier session: a session
    whose spins are missing, whose activities are not the same number for
    every call (each kernel a whole multiple of the calls), or whose device
    time exceeds the time between the events is run again, up to
    PROFILER_TRIES sessions in all. If none passes, the time between the
    events of the last session is taken (the calls back to back, the gaps
    between kernels counted), logged and listed in EVENT_TIMINGS, which the
    timing phase reports."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(1, PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(PAD_SPIN_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        window = session_window(
            (ev.name, ev.time_range.start, ev.self_device_time_total) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False))
        wall_us = start.elapsed_time(end) * 1e3
        counts = collections.Counter(name for name, _ in window or ())
        us = sum(d for _, d in window or ())
        # every call launches the same kernels, at least one, one after
        # another on one stream: a session that lost some of them (K3 read
        # 250% of its bound from one on the H100) or that holds more device
        # time than passed (K3 read 15x its events' time) is run again
        if (window and all(c % reps == 0 for c in counts.values())
                and us <= 1.02 * wall_us + 5):
            return us / 1e3 / reps
        log(f"    torch.profiler session {attempt} of {PROFILER_TRIES}: "
            f"{'no spins around the calls' if window is None else f'{sum(counts.values())} activities of {len(counts)} kernels'}"
            f" for {reps} calls ({us:.1f} us of device time in {wall_us:.1f} us between the "
            f"events)")
    ms = wall_us / 1e3 / reps
    where = f"{fn.__qualname__} at line {fn.__code__.co_firstlineno}"
    EVENT_TIMINGS.append(where)
    log(f"    timed with CUDA events instead: {ms:.4f} ms per call ({where})")
    return ms


def paired_ms(kernel, library, reps: int, rounds: int = 3):
    """device_ms of a kernel and of its library call, in turns (kernel,
    library, kernel, ...) for ``rounds`` rounds: the median of each, and
    the rounds. On the H100 a kernel's first rounds after other work read up
    to 1.5x its later ones now and then; turns keep the two comparable. The
    first round alone is one device_ms of each, the method of the timings
    before the turns: the timing phase logs its ratio beside the medians'."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(device_ms(kernel, reps))
        ls.append(device_ms(library, reps))
    return float(np.median(ks)), float(np.median(ls)), ks, ls


def clock_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_time(fn, reps: int, warmup: int = 3) -> float:
    """Mean wall milliseconds per call over ``reps`` back-to-back calls, from
    CUDA events: the device time, or the host's launch rate where that is
    slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a kernel whose time reads more than this share of its bound fails the timing
# phase: a reading beyond 100% means the timer or the bound is wrong
BOUND_SHARE_LIMIT = 1.05


def bound_gate(what, bound_ms, ms):
    """Raise when a kernel read faster than the least time the card could take."""
    if bound_ms > BOUND_SHARE_LIMIT * ms:
        raise AssertionError(f"{what}: {ms:.5f} ms is {100 * bound_ms / ms:.1f}% of its "
                             f"bound {bound_ms:.5f} ms, over {100 * BOUND_SHARE_LIMIT:g}%: "
                             f"the timer or the bound is wrong")


def cold_ring(make, nbytes):
    """(call, copies): ``make()`` builds one set of a call's inputs; enough
    sets that, taken in turn, more than twice the card's L2 is moved
    between two uses of one set (at most 64 sets), and a ring that keeps
    each call's output alive until its set comes round again, so that no
    output lands on the block the last one freed. ``call(fn)`` runs ``fn``
    on the next set. A kernel timed back to back on one input finds it in
    L2 when it fits (the H100's is 50 MB), and reads faster than a model's
    call, which finds its input in HBM."""
    import torch

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = max(1, min(64, -(-2 * l2 // max(int(nbytes), 1))))
    sets = [make() for _ in range(n)]
    ring = [None] * n
    turn = [0]

    def call(fn):
        i = turn[0] % n
        turn[0] += 1
        ring[i] = None
        ring[i] = fn(*sets[i])
        return ring[i]
    return call, n


def counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from lidar_layout_tpu_torch.ops import attention as A
    from lidar_layout_tpu_torch.ops import chamfer as C
    from lidar_layout_tpu_torch.ops import groupnorm as G

    return {"flash_attention": A.flash_attention, "flash_attention_bwd": A.flash_attention_bwd,
            "group_norm": G.group_norm, "group_norm_bwd": G.group_norm_bwd,
            "chamfer_nn": C.nn_dist_one_way}


def sp_counters():
    """The launch counters of the sp axis's kernels (the cross-length K1 and
    the split K3's two), by kernel name: no other path launches them."""
    from lidar_layout_tpu_torch.ops import attention as A
    from lidar_layout_tpu_torch.ops import groupnorm as G

    return {"flash_attention_xl": A.flash_attention_xl, "group_norm_stats": G.group_norm_stats,
            "group_norm_apply": G.group_norm_apply}


def reset_counts():
    for fn in (*counters().values(), *sp_counters().values()):
        fn.launches = 0


def ae_step(model, disc, loss_cfg, geo, timed=False):
    """The VQ-GAN step of ``train/ae_trainer``, with the s2 branch (the
    Gaussian tower rendered in the YAML's geometry) for a VQModelGaus, as
    train_lidm builds it."""
    from lidar_layout_tpu_torch.models.autoencoder_gaus import VQModelGaus
    from lidar_layout_tpu_torch.train import ae_trainer as AT

    s2 = isinstance(model, VQModelGaus)
    return AT.make_ae_train_step(model, disc, loss_cfg, geo, timed=timed, s2_render=s2,
                                 s2_geom=geo.geom if s2 else None)


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def yaml_config(path, overrides=()):
    """A YAML config with dotlist ``overrides`` merged, as train_lidm reads it."""
    from lidar_layout_tpu_torch.config import apply_dotlist, load_yaml

    return apply_dotlist(load_yaml(path), list(overrides))


# ------------------------------------------------------------------ ddp ranks
# The ddp phase's rank bodies: each runs in a process of its own, started by
# parallel.dryrun.spawn as torchrun starts ranks (RANK, WORLD_SIZE, LOCAL_RANK
# set), and returns numbers, not tensors.
# global batch, train_lidm steps, timed steps in (a) and in (b) (two ranks on one card)
DDP_BATCH, DDP_STEPS, DDP_TIMED, DDP_TIMED_SHARED = 16, 2, 5, 1
# (b)'s check of train_lidm's per-rank seeding: the flagship YAML shrunk as
# tests/test_torch_parallel_train.py shrinks it (the seeding does not depend
# on the model's size)
DDP_SEED_TINY = ("model.params.timesteps=64", "model.params.image_size=[4,16]",
                 "model.params.unet_config.params.model_channels=32",
                 "model.params.unet_config.params.num_res_blocks=1",
                 "model.params.unet_config.params.attention_resolutions=[2]",
                 "model.params.unet_config.params.channel_mult=[1,2]",
                 "model.params.unet_config.params.num_head_channels=8",
                 "model.params.first_stage_config.params.n_embed=256",
                 "model.params.first_stage_config.params.ddconfig.ch=16",
                 "model.params.first_stage_config.params.ddconfig.num_res_blocks=1",
                 "data.params.dataset.size=[16,128]", "data.params.batch_size=2",
                 "data.params.num_val_batches=1")


def ddp_cli_args(workdir):
    """train_lidm on the flagship YAML at full width: synthetic scenes, bf16,
    global batch 16, DDP_STEPS steps, one checkpoint (at the last step; the
    best one links it); validation on one batch at the last step, no image
    logger."""
    return ["-b", LIDM_YAML, "--synthetic", "--bf16", "--steps", str(DDP_STEPS),
            "--workdir", workdir, f"data.params.batch_size={DDP_BATCH}",
            f"data.params.ckpt_every_steps={DDP_STEPS}",
            "data.params.num_val_batches=1", "data.params.val_every_steps=1000",
            "data.params.sample_every_steps=1000"]


def ddp_flagship(state_dict=None, dtype=None):
    """The full-width flagship built on the card (its modules' own
    initialisation runs there, not on the host), with ``state_dict``
    loaded when given."""
    import torch
    from lidar_layout_tpu_torch.flagship import flagship

    with torch.device("cuda"):
        model, _ = flagship(dtype=dtype or torch.float32, device="cuda")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _ddp_exact():
    """The card's arithmetic as the comparisons need it: TF32 off, cuDNN's
    deterministic algorithms (its default ones may sum a weight gradient
    with atomics, in an order that changes from run to run)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _step_structure(model):
    """K1, K2, K3 forward and backward launches of one flagship training
    step: a self-attention block's forward and backward, every U-Net norm's
    forward and backward, the frozen encoder's norms forward only."""
    unet_norms = sum(type(m).__name__ == "Normalize" for m in model.unet.modules())
    enc_norms = sum(type(m).__name__ == "Normalize"
                    for m in model.first_stage_model.encoder.modules())
    attn = sum(type(m).__name__ == "SelfAttentionBlock" for m in model.unet.modules())
    return {"flash_attention": attn, "flash_attention_bwd": attn,
            "group_norm": unet_norms + enc_norms, "group_norm_bwd": unet_norms,
            "chamfer_nn": 0}


def _checksums(module):
    """Per-parameter (sum, position-weighted sum) of the bit patterns, int64:
    equal on two ranks when the parameters are bit for bit equal (but for a
    collision)."""
    import torch

    out = []
    for p in module.parameters():
        bits = p.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(1, bits.numel() + 1, device=bits.device)
        out.append([int(bits.sum()), int((bits * w).sum())])
    return np.asarray(out, np.int64)


def _adam_diff(a, b, lr):
    """Largest difference of two parameter sets after one AdamW step, in lr,
    and the share of elements off by more than 0.01 lr."""
    import torch

    d = torch.cat([(x.float() - y.float()).abs().reshape(-1) for x, y in zip(a, b)])
    return float(d.max()) / lr, float((d > 0.01 * lr).float().mean())


def _halves_step(model, state, batch, gen):
    """One process doing what two ranks of half the batch do in one bf16
    training step: the global batch's t and noise, each half's loss and
    gradient at half the batch, their mean, one update. (loss, grad_norm)."""
    import torch
    from lidar_layout_tpu_torch.train.diffusion_trainer import _autocast

    model.train()
    model.first_stage_model.eval()
    img = batch["image"]
    halves = img.split(img.shape[0] // 2)
    t = noise = None
    losses = []
    for i, part in enumerate(halves):
        with _autocast(model, torch.bfloat16):
            z = model.encode_first_stage(part)
        if t is None:
            t, noise = model.draw_t_noise(z.new_empty((img.shape[0], *z.shape[1:])), gen)
        sl = slice(i * z.shape[0], (i + 1) * z.shape[0])
        with _autocast(model, torch.bfloat16):
            loss, _ = model.p_losses(z, t[sl], noise[sl], None)
        loss.backward()
        losses.append(loss.detach())
    grads = [(torch.zeros_like(p) if p.grad is None else p.grad) / len(halves)
             for p in state.optimizer.params]
    norm = state.optimizer.step(grads)
    return float(sum(losses) / len(losses)), float(norm)


def ddp_nccl_rank(workdir):
    """(a): train_lidm at full width through NCCL at world = card count, then
    DDP_TIMED timed steps of its state, the all-reduce's own time, one FSDP
    step (world size 1 when one card) against the plain step, and the dry
    run (``parallel.dryrun.dryrun_body``) in the same ranks."""
    import gc

    import torch
    from lidar_layout_tpu_torch.parallel import collectives as C
    from lidar_layout_tpu_torch.parallel.dryrun import dryrun_body
    from lidar_layout_tpu_torch.parallel.mesh import fully_shard_module, make_mesh, shard_batch
    from lidar_layout_tpu_torch.train import diffusion_trainer as DT
    from lidar_layout_tpu_torch.train.checkpoint import full_tensors
    from lidar_layout_tpu_torch.train.train_lidm import main as train_lidm

    entered = time.time()   # on the host's clock, as the parent's spawn
    _ddp_exact()
    t0 = time.perf_counter()
    trainer = train_lidm(ddp_cli_args(workdir))
    torch.cuda.synchronize()
    out = {"cli_s": time.perf_counter() - t0, "world": C.get_world_size(),
           "backend": torch.distributed.get_backend()}
    state, step, gen = trainer.state, trainer.step_fn, trainer.generator
    batches = [next(trainer.data_iter) for _ in range(DDP_TIMED)]
    state, _ = step(state, batches[0], gen)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for b in batches:
        state, logs = step(state, b, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(steps_per_s=DDP_TIMED / wall, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={k: v / DDP_TIMED for k, v in read_counts().items()},
               structure=_step_structure(state.model), loss=float(logs["loss"]))
    grads = [torch.randn_like(p) for p in state.params.values()]
    C.all_reduce_grads(grads)   # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(3):
        C.all_reduce_grads(grads)
    ev[1].record()
    torch.cuda.synchronize()
    out["all_reduce_ms"] = ev[0].elapsed_time(ev[1]) / 3
    out["timed_s"] = time.perf_counter() - t0
    plain = state.model   # the trained weights serve as they are
    del trainer, state, step, grads
    gc.collect()
    torch.cuda.empty_cache()

    # one FSDP step against the plain step, same weights, batch and draws
    t0 = time.perf_counter()
    sharded = ddp_flagship(plain.state_dict())
    spec = fully_shard_module(make_mesh(fsdp=C.get_world_size()), sharded.unet)
    batch = Smoke._train_batches(False, 1, seed=6, batch=DDP_BATCH)[0]
    mine = shard_batch(batch, DDP_BATCH)
    lr = 1e-4
    after = {}
    for name, model in (("plain", plain), ("fsdp", sharded)):
        params = DT.trainable_params(model)
        st = DT.create_train_state(model, DT.make_optimizer(params, lr), params)
        reset_counts()
        st, logs = DT.make_train_step(model, autocast_dtype=torch.bfloat16)(
            st, mine, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        after[name] = list(full_tensors({k: p.detach() for k, p in params.items()}).values())
        out[f"{name}_launches"] = read_counts()
        out[f"{name}_loss"] = float(logs["loss"])
        out[f"{name}_norm"] = float(logs["grad_norm"])
    out["fsdp_sharded"] = sum(ax is not None for ax in spec.values())
    out["fsdp_params"] = len(spec)
    out["fsdp_bit_equal"] = all(torch.equal(a, b) for a, b in zip(after["plain"], after["fsdp"]))
    out["fsdp_diff_lr"], out["fsdp_share_off"] = _adam_diff(after["plain"], after["fsdp"], lr)
    out["fsdp_s"] = time.perf_counter() - t0
    del plain, sharded, after
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()   # the dry run in the same ranks
    out["dryrun"] = dryrun_body("cuda")
    out["dryrun_s"] = time.perf_counter() - t0
    out["entered"], out["left"] = entered, time.time()
    return out


def ddp_gloo_rank(ref_dir):
    """(b): the rehearsal, two ranks on one card over gloo: train_lidm's
    set-up (``prepare``) of a tiny run, then a draw from each rank's default
    CUDA generator (dropout's; seeded with seed + rank); one bf16 step of the
    full-width flagship at global batch 16 (8 a rank), DDP_TIMED_SHARED
    timed steps, then a dp-sharded DPM-20 generate(16) gathered through the
    host."""
    import torch
    from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
    from lidar_layout_tpu_torch.parallel import collectives as C
    from lidar_layout_tpu_torch.parallel.mesh import shard_batch
    from lidar_layout_tpu_torch.pipeline import GenerationPipeline
    from lidar_layout_tpu_torch.train import diffusion_trainer as DT
    from lidar_layout_tpu_torch.train.train_lidm import prepare

    entered = time.time()
    run = prepare(["-b", LIDM_YAML, "--synthetic", "--steps", "1",
                   "--workdir", os.path.join(ref_dir, "seeding"), *DDP_SEED_TINY])
    del run
    draws = C.host_all_gather(torch.randn(8, device="cuda").cpu().numpy())
    _ddp_exact()
    seeded = torch.load(os.path.join(ref_dir, "seeded.pt"), map_location="cuda")
    model = ddp_flagship(seeded)
    params = DT.trainable_params(model)
    state = DT.create_train_state(model, DT.make_optimizer(params, 1e-4), params)
    batches = Smoke._train_batches(False, 1 + DDP_TIMED_SHARED, seed=6, batch=DDP_BATCH)
    step = DT.make_train_step(model, autocast_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_counts()
    state, logs = step(state, shard_batch(batches[0], DDP_BATCH), gen)
    torch.cuda.synchronize()
    out = {"launches": read_counts(), "structure": _step_structure(model),
           "loss": float(C.reduce_mean(logs["loss"])), "grad_norm": float(logs["grad_norm"]),
           "rank": C.get_rank(), "backend": torch.distributed.get_backend(),
           "dropout_draws_differ": not np.array_equal(draws[0], draws[1])}
    sums = C.host_all_gather(_checksums(model.unet))
    out["replicas_equal"] = bool((sums == sums[0]).all())
    if C.get_rank() == 0:   # against the one-process batch-16 step and its halves
        mine = [p.detach() for _, p in model.unet.named_parameters()]
        for key in ("16", "halves"):
            ref = torch.load(os.path.join(ref_dir, f"unet_{key}.pt"), map_location="cuda")
            ref = [ref[n] for n, _ in model.unet.named_parameters()]
            out[f"equal_{key}"] = all(torch.equal(a, b) for a, b in zip(mine, ref))
            out[f"diff_lr_{key}"], out[f"share_off_{key}"] = _adam_diff(mine, ref, 1e-4)
            del ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, _ = step(state, shard_batch(b, DDP_BATCH), gen)
    torch.cuda.synchronize()
    out["steps_per_s"] = DDP_TIMED_SHARED / (time.perf_counter() - t0)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step, params, model
    torch.cuda.empty_cache()
    model = ddp_flagship(seeded, torch.bfloat16)
    res = GenerationPipeline(model, KITTI_GEOMETRY, sampler="dpm", steps=20).generate(
        DDP_BATCH, seed=0, batch=DDP_BATCH)
    if C.get_rank() == 0:
        np.save(os.path.join(ref_dir, "dp_images.npy"), res.images)
    out["entered"], out["left"] = entered, time.time()
    return out


# ------------------------------------------------------------------ sp ranks
# the sp phase: ranks sharing one card over gloo, the global batch (JAX's dry
# run's), and JAX's tolerance for the W-sharded forward against the unsharded
SP_RANKS, SP_BATCH, SP_TOL = 4, 2, 2e-4


def sp_inputs(timesteps):
    """The sp phase's (image, latent, t), drawn from seed 11 as numpy: a
    (2, 64, 1024, 1) image, a (2, 16, 128, 8) latent, t = T/2. Each rank
    draws them itself: a spawned rank's arguments go through a pipe that a
    rank reads only once it has imported torch, so half a megabyte of them
    started the ranks one at a time (6 s apart on the H100 host)."""
    rng = np.random.default_rng(11)
    image = rng.uniform(-1, 1, (SP_BATCH, 64, 1024, 1)).astype(np.float32)
    latent = rng.standard_normal((SP_BATCH, 16, 128, 8)).astype(np.float32)
    return image, latent, np.full((SP_BATCH,), timesteps // 2)


def sp_rank():
    """A rank of the sp phase: the full-width flagship in f32 on the tests'
    seeded weights, on a (dp, 1, sp) mesh of every rank (``sp_size``): one
    warm W-sharded encode of the image and ``apply_model`` of the latent at
    t (``sp_inputs``, ``spatial_forward``), then a counted one, gathered;
    its launches of every kernel, the structure (SelfAttentionBlocks,
    Normalizes) and the hooks' calls by shape; seconds."""
    import torch
    from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
    from lidar_layout_tpu_torch.nn.blocks import Normalize
    from lidar_layout_tpu_torch.parallel import collectives as C
    from lidar_layout_tpu_torch.parallel.dryrun import sp_size, spatial_forward
    from lidar_layout_tpu_torch.parallel.mesh import make_mesh

    entered = time.time()
    _ddp_exact()
    model = seed_weights(ddp_flagship(), 0)
    n = C.get_world_size()
    sp = sp_size(n)
    mesh = make_mesh(sp=sp)
    args = [torch.from_numpy(a).cuda() for a in sp_inputs(model.cfg.timesteps)]
    t0 = time.perf_counter()
    spatial_forward(model, mesh, *args)   # warm: cuDNN's choices, the groups' first use
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    mods = [*model.first_stage_model.encoder.modules(), *model.unet.modules()]
    norms = [m for m in mods if isinstance(m, Normalize)]
    attn = [m for m in mods if isinstance(m, SelfAttentionBlock)]
    calls = collections.Counter()

    def norm_hook(mod, a):
        b, c, h, w = a[0].shape
        calls["group_norm_split", (b, c, h, w, mod.num_groups, mod.act)] += 1

    def attn_hook(mod, a):
        b, c, h, w = a[0].shape
        calls["flash_attention_xl", (b, mod.num_heads, h * w, h * w * sp,
                                     c // mod.num_heads)] += 1
    hooks = ([m.register_forward_pre_hook(norm_hook) for m in norms]
             + [m.register_forward_pre_hook(attn_hook) for m in attn])
    reset_counts()
    t0 = time.perf_counter()
    z, eps = spatial_forward(model, mesh, *args)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "warm_s": warm_s,
           "launches": {k: fn.launches for k, fn in sp_counters().items()},
           "others": read_counts(), "calls": dict(calls),
           "structure": {"flash_attention_xl": len(attn), "group_norm_stats": len(norms),
                         "group_norm_apply": len(norms)},
           "mesh": {k: mesh[k].size() for k in mesh.mesh_dim_names},
           "backend": torch.distributed.get_backend(), "rank": C.get_rank()}
    every = C.host_all_gather(eps.cpu().numpy())   # every rank gathered the same output
    out["same"] = all(np.array_equal(e, every[0]) for e in every)
    for h in hooks:
        h.remove()
    if C.get_rank() == 0:
        out["z"], out["eps"] = z.cpu().numpy(), eps.cpu().numpy()
    out["entered"], out["left"] = entered, time.time()
    return out


class Smoke:
    def __init__(self):
        self.kernel_err = {name: 0.0 for name, _, _ in KERNELS}
        self.launches = {}
        self.train_launches = {}
        self.shapes = None   # main-path kernel shapes and their launches per request
        self.gn_where = None   # K3's main-path launches by (shape, "unet" or "decoder")
        self.train_shapes = {}   # the same for one training step, by layout (False, True)
        self.eval_launches = {}
        self.eval_clouds = None    # the eval's (reference, sample) clouds: K4's shapes
        self.layout_shapes = None  # K3's layout-path launches by (shape, origin)
        self.layout_launches = {}
        self.layout_train_launches = {}
        self.layout_boxes_launches = {}
        self.layout_boxes_train_launches = {}   # over LayoutDiffusion's timed training steps
        self.box_attention_calls = None   # K1 calls of one LayoutDiffusion request (hooks)
        self.run_totals = {}   # kernel -> {run: summed times} of the layout and AE paths
        self.ae_shapes = None   # K3's (forward, backward) calls of one AE step by shape
        self.ae_train_launches = {}   # over the AE's timed training steps
        self.ae_run = None   # the ae_train phase's kitti CLI run, which ae_eval scores
        self.ae_eval_launches = {}
        self.coarse_shapes = None   # the coarse LiDM's and AE's kernel calls by shape
        self.coarse_launches = {}   # over the coarse DPM-20 run
        self.coarse_train_launches = {}   # over the coarse LiDM's timed training steps
        self.coarse_ae_train_launches = {}   # over the coarse AE's timed training steps
        self.cube_launches = {}   # over the cube stage's timed steps and DDIM-50
        self.dense_launches = {}   # over the dense decoder's DECODE_CLOUDS timed decodes
        self.dense_train_launches = {}   # over its timed training steps
        self.gaus_ae_train_launches = {}   # over the Gaussian AE's timed training steps
        self.gaus_ae_shapes = None   # K3's (forward, backward) calls of one Gaussian-AE step
        self.ae_eval_clouds = None   # eval_ae's (input, reconstruction) clouds: K4's shapes
        self.cond_shapes = None   # the conditional path's kernel calls by shape (hooks)
        self.cond_launches = {}   # over the three conditional CLIs' requests
        self.r2dm_shapes = None   # K3's (forward, backward) calls of one R2DM step by shape
        self.families_launches = {}   # run -> launches: a request, the timed steps
        self.split_shapes = None   # K1's and K3's calls of one patched request by shape
        self.split_launches = {}   # over the patched DPM-20 run
        self.ae_bf16_shapes = None   # K3's calls of one bf16 AE step: (AE, discriminator)
        self.ae_bf16_launches = {}   # over the bf16 AE's timed training steps
        self.k3_times = {}   # K3's timings by (shape, dtype, eps, backward), shared by paths
        self.sonata_launches = {}   # over Sonata's timed pre-training steps
        self.cond_train_shapes = {}   # K1 and K3 calls of one conditional training step
        self.cond_train_launches = {}   # "crossattn", "concat" -> over their timed steps
        self.ddp_launches = {}   # a rank's launches over ddp (a)'s timed steps
        self.ddp_dryrun = None   # the dry run's results from ddp (a)'s rank 0
        self.sp_launches = {}   # a rank's launches over the sp phase's sharded forward
        self.sp_shapes = None   # its cross-length K1 and split K3 calls by shape
        self.sp_size = None   # its shards of the width
        self._tmp = []   # directories the phases write, removed at the end

    def tmp_dir(self, prefix):
        import tempfile

        self._tmp.append(tempfile.mkdtemp(prefix=prefix))
        return self._tmp[-1]

    def cleanup(self):
        import shutil

        for d in self._tmp:
            shutil.rmtree(d, ignore_errors=True)

    # ------------------------------------------------------------------ device
    def device(self):
        import torch

        log("torch", torch.__version__, "cuda", torch.version.cuda, "python",
            sys.version.split()[0])
        log("card:", card_line(), "| devices:", torch.cuda.device_count())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    # ------------------------------------------------------------------- build
    def build(self):
        from lidar_layout_tpu_torch.ops import _build

        t0 = time.perf_counter()
        logs = _build.build()
        log(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(logs) or 'nothing (cached)'}")
        for name, (sec, text) in sorted(logs.items()):
            log(f"  {name}: nvcc {sec:.1f} s")
            for line in text.splitlines():
                if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                    log("   ", line.strip())

    # ----------------------------------------------------------------- kernels
    def _check(self, name, got, want, atol, rtol, what, record=True):
        import torch

        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        ok = err <= atol + rtol * scale and bool(torch.isfinite(got.float()).all())
        log(f"  {name} {what}: max_abs_err={err:.3e} max_rel_err={err / max(scale, 1e-30):.3e} "
            f"(|ref|max {scale:.3e}, tol {atol:g}+{rtol:g}*|ref|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {what} disagrees with its plain version")
        if record and got.dtype == torch.bfloat16:
            self.kernel_err[name] = max(self.kernel_err[name], err)

    def kernels(self):
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from torch_port_helpers import ATTN_EDGE_CASES, attn_inputs   # tests/ is on sys.path

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(1)
        # f32: the kernel and the plain version differ only in summation order;
        # bf16: both round the output to bf16 and the kernel also rounds the
        # unnormalised p to bf16 (the plain version rounds the normalised p)
        tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
        log("K1 flash_attention vs _attend_ref:")
        for dtype in (torch.float32, torch.bfloat16):
            for (b, h, s, d), fused, masked in ATTN_CASES + ATTN_EDGE_CASES:
                q, k, v, kb = attn_inputs(gen, b, h, s, d, dtype, fused, masked)
                got = A.flash_attention(q, k, v, kb)
                want = A._attend_ref(q, k, v, kb)
                self._check("flash_attention", got, want, *tol[dtype],
                            f"{(b, h, s, d)} {str(dtype)[6:]} fused={fused} kbias={masked}")
        # one launch of the bf16 kernel sums in a fixed order: bit for bit
        for (b, h, s, d), fused, masked in (ATTN_CASES[0], ((2, 2, 384, 32), False, "tile")):
            q, k, v, kb = attn_inputs(gen, b, h, s, d, torch.bfloat16, fused, masked)
            o1, l1 = A._launch(q, k, v, kb, with_lse=True)
            o2, l2 = A._launch(q, k, v, kb, with_lse=True)
            same = bool(torch.equal(o1, o2)) and bool(torch.equal(l1, l2))
            log(f"  flash_attention {(b, h, s, d)} bf16 kbias={masked}: two launches bit for "
                f"bit equal (o and lse): {same}")
            if not same:
                raise AssertionError("K1 is not deterministic")
        self._kernels_boxes_attention(gen)

        log("K3 group_norm vs _ref (at every main-path shape and every layout-path shape: the "
            "layout U-Net at batch 16 and, guided, 32, the nuScenes VQ decoder; then shapes "
            "that take the two-sweep path: H*W not a multiple of the 16-byte pack, and a span "
            "of 4 or 8 MB):")
        shapes = ({k[:5] for k in self._main_shapes()["group_norm"]}
                  | {k[0][:5] for k in self._layout_shapes()})
        sweep = [(2, 40, 5, 7, 20), (1, 64, 128, 1024, 4)]
        paths = set()
        for dtype in (torch.float32, torch.bfloat16):
            for (bsz, c, hh, ww, groups) in sorted(shapes) + sweep:
                x = (torch.randn((bsz, c, hh, ww), generator=gen, device=dev) * 2 + 0.3).to(dtype)
                gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
                beta = 0.1 * torch.randn(c, generator=gen, device=dev)
                path = G.kernel_path(dtype, c, hh * ww, groups)
                paths.add(min(path, 2))
                for act in (False, True):
                    got = G.group_norm(x, gamma, beta, groups, 1e-6, act)
                    want = G._ref(x, gamma, beta, groups, 1e-6, act)
                    self._check("group_norm", got, want,
                                *( (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 1e-2)),
                                f"{(bsz, c, hh, ww)} G={groups} {str(dtype)[6:]} act={act} "
                                f"path: {path_name(path)}")
        if paths != {0, 1, 2}:
            raise AssertionError(f"K3 forward: not every path ran (cluster sizes {paths})")
        # a large-mean group of 262K values, against float64 statistics. The
        # kernel works on x minus the group's first element, which is exact
        # here, so it is held to the f32 tolerance above; a mean formed near
        # 300 in f32 would be off by up to half an ulp (1.5e-5), already
        # 1.5e-4 of the std 0.1, and a one-pass E[x^2] - E[x]^2 in f32 would
        # lose the variance (the ulp of 9e4 is ~8e-3, the variance 1e-2)
        x = torch.randn((2, 128, 64, 1024), generator=gen, device=dev) * 0.1 + 300.0
        gamma, beta = torch.ones(128, device=dev), torch.zeros(128, device=dev)
        xd = x.double().reshape(2, 32, -1)
        mean = xd.mean(dim=2, keepdim=True)
        ref64 = ((xd - mean) / torch.sqrt((xd - mean).square().mean(dim=2, keepdim=True)
                                          + 1e-6)).reshape(x.shape).float()
        self._check("group_norm", G.group_norm(x, gamma, beta, 32, 1e-6, False), ref64,
                    1e-4, 1e-5, "(2, 128, 64, 1024) mean 300 std 0.1 f32 vs f64 statistics, "
                    f"path: {path_name(G.kernel_path(torch.float32, 128, 64 * 1024, 32))}")

        self._kernels_gn_bwd()
        self._kernels_ae()
        self._kernels_coarse()
        self._kernels_dense()
        self._kernels_cond()
        self._kernels_families()
        self._kernels_split()
        self._kernels_ae(key="ae_bf16", label="the AE's training step in bf16",
                         dtype=torch.bfloat16)
        self._kernels_train()
        self._kernels_chamfer()

    @staticmethod
    def _box_qkv(gen, count=3):
        """``count`` (256, 8, 1, 64) f32 tensors laid out as LayoutDiffusion's
        CrossAttention hands them to K1 and K2: (N, 1, 8 * 64) projections
        reshaped to (N, 1, 8, 64) and viewed as (N, 8, 1, 64)."""
        import torch

        n, heads, dh = BOX_SCENES * 16, 8, 64
        return [torch.randn((n, 1, heads * dh), generator=gen, device="cuda")
                .reshape(n, 1, heads, dh).transpose(1, 2) for _ in range(count)]

    def _kernels_boxes_attention(self, gen):
        """K1 and K2 at LayoutDiffusion's shape, on q, k, v and dO laid out
        as its CrossAttention makes them, f32: K1 (and its log-sum-exp)
        against the plain version, K2 against _attend_bwd_ref, each bit for
        bit over two launches. With one key the softmax is exactly 1, and
        JAX's dq and dk are exactly 0: K2's must be too."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A

        q, k, v, do = self._box_qkv(gen, 4)
        what = f"{tuple(q.shape)} f32 (S = 1: one row of a 128-row tile; CrossAttention's strides)"
        log(f"K1 and K2 at LayoutDiffusion's shape {what}:")
        got = A.flash_attention(q, k, v)
        want = A._attend_ref(q, k, v)
        self._check("flash_attention", got, want, 2e-5, 1e-4, what, record=False)
        self.kernel_err["flash_attention_boxes"] = max_err(got, want)[0]
        o, lse = A._launch(q, k, v, None, with_lse=True)
        o2, lse2 = A._launch(q, k, v, None, with_lse=True)
        torch.cuda.synchronize()
        err, scale = max_err(lse, A._lse_ref(q, k))
        same = (bool(torch.equal(got, A.flash_attention(q, k, v))) and bool(torch.equal(o, o2))
                and bool(torch.equal(lse, lse2)))
        log(f"  lse {what}: max_abs_err={err:.3e} (tol 2e-4+1e-5*|ref|); K1 two launches bit for "
            f"bit equal (o, and o and lse): {same}")
        if not same or not err <= 2e-4 + 1e-5 * scale:
            raise AssertionError("K1 at S = 1: log-sum-exp off or not deterministic")
        grads = A.flash_attention_bwd(q, k, v, o, do, lse)
        want = A._attend_bwd_ref(q, k, v, o, do, lse)
        for part, g_, w_ in zip(("dq", "dk", "dv"), grads, want):
            self._check("flash_attention_bwd", g_, w_, 1e-4, 1e-4, f"{part} {what}", record=False)
            self.kernel_err["flash_attention_bwd_boxes"] = max(
                self.kernel_err.get("flash_attention_bwd_boxes", 0.0), max_err(g_, w_)[0])
        again = A.flash_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a_, g_)) for a_, g_ in zip(again, grads)]
        dq_max, dk_max = (float(t_.abs().max()) for t_ in grads[:2])
        log(f"  flash_attention_bwd {what}: two launches bit for bit equal (dq, dk, dv): {same}; "
            f"largest |dq| {dq_max:.3e}, |dk| {dk_max:.3e} (JAX's: 0 exactly); largest |dv - dO| "
            f"{float((grads[2] - do).abs().max()):.3e}")
        if not all(same):
            raise AssertionError("K2 at S = 1 is not deterministic")
        if dq_max or dk_max:
            raise AssertionError("K2 at S = 1: dq and dk are not exactly 0, as JAX's are")

    def _kernels_gn_bwd(self):
        """K3's backward kernel against _group_norm_bwd_ref at every training
        shape, f32 and bf16, SiLU off and on, and at shapes that take its
        two-sweep path; dx, dgamma and dbeta bit for bit over two launches."""
        import torch
        from lidar_layout_tpu_torch.ops import groupnorm as G

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(8)
        shapes = sorted({k[:5] for k in self._train_shapes()["group_norm_bwd"]}
                        | {k[:5] for k in self._train_shapes(layout=True)["group_norm_bwd"]})
        # H*W = 35 takes the scalar sweep; (1, 128, 64, 1024) has spans of 4
        # channels of 64K elements, 1 MB (bf16) or 2 MB (f32) of x and dy,
        # more than 4 blocks of whole channels hold: the sweep too
        extra = [(2, 40, 5, 7, 20), (1, 128, 64, 1024, 32)]
        log("K3 backward group_norm_bwd vs _group_norm_bwd_ref at every training shape of "
            "the flagship and of the layout model (both in f32 arithmetic from "
            "the same x and dy; dx rounded to x's dtype, dgamma/dbeta sum B*H*W products):")
        paths = set()
        for dtype in (torch.float32, torch.bfloat16):
            tol_dx = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
            for (bsz, c, hh, ww, groups) in shapes + extra:
                x = (torch.randn((bsz, c, hh, ww), generator=gen, device=dev) * 2 + 0.3).to(dtype)
                gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
                beta = 0.1 * torch.randn(c, generator=gen, device=dev)
                dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
                path = G.kernel_path(dtype, c, hh * ww, groups, backward=True)
                paths.add(min(path, 2))
                for act in (False, True):
                    what = (f"{(bsz, c, hh, ww)} G={groups} {str(dtype)[6:]} act={act} "
                            f"path: {path_name(path)}")
                    before = G.group_norm_bwd.launches
                    got = G.group_norm_bwd(x, gamma, beta, dy, groups, 1e-6, act)
                    want = G._group_norm_bwd_ref(x, gamma, beta, dy, groups, 1e-6, act)
                    if G.group_norm_bwd.launches != before + 1:
                        raise AssertionError("group_norm_bwd did not count its launch")
                    for part, g_, w_, t_ in zip(("dx", "dgamma", "dbeta"), got, want,
                                                (tol_dx, (1e-3, 1e-4), (1e-3, 1e-4))):
                        self._check("group_norm_bwd", g_, w_, *t_, f"{part} {what}")
                    again = G.group_norm_bwd(x, gamma, beta, dy, groups, 1e-6, act)
                    torch.cuda.synchronize()
                    same = [bool(torch.equal(a, b)) for a, b in zip(again, got)]
                    log(f"  group_norm_bwd {what}: two launches bit for bit equal "
                        f"(dx, dgamma, dbeta): {same}")
                    if not all(same):
                        raise AssertionError("K3's backward is not deterministic")
                del x, dy, got, want, again
        if paths != {0, 1, 2}:
            raise AssertionError(f"K3 backward: not every path ran (cluster sizes {paths})")

    def _kernels_train(self):
        """K1's log-sum-exp, K2, and the gradients of both autograd Functions
        on CUDA against autograd of their plain versions."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from torch_port_helpers import ATTN_EDGE_CASES, attn_inputs

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(2)
        # K2 in f32 differs from the plain version in summation order only;
        # in bf16 both round P and dS to bf16 before their products, but the
        # kernel forms P as exp2 of log2-scaled logits, so a few P and dS
        # values round to the neighbouring bf16, and dq/dk/dv are rounded to
        # bf16 at the end
        tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
        log("K1 log-sum-exp and K2 flash_attention_bwd vs _lse_ref / _attend_bwd_ref "
            "(o and lse from K1):")
        cases = [((16, 8, 2048, 32), True, False), ((16, 16, 512, 32), True, False),
                 ((16, 32, 128, 32), True, False), ((4, 8, 1000, 32), False, True),
                 ((2, 4, 333, 64), True, True), ((2, 2, 200, 128), False, True),
                 ((2, 2, 130, 16), True, False)]
        for dtype in (torch.float32, torch.bfloat16):
            for (b, h, s, d), fused, masked in cases + ATTN_EDGE_CASES:
                q, k, v, kb = attn_inputs(gen, b, h, s, d, dtype, fused, masked)
                what = f"{(b, h, s, d)} {str(dtype)[6:]} fused={fused} kbias={masked}"
                o, lse = A._launch(q, k, v, kb, with_lse=True)
                torch.cuda.synchronize()
                err, scale = max_err(lse, A._lse_ref(q, k, kb))
                if not err <= 2e-4 + 1e-5 * scale:
                    raise AssertionError(f"K1 log-sum-exp {what}: max_abs_err {err:.3e}")
                log(f"  lse {what}: max_abs_err={err:.3e} (tol 2e-4+1e-5*|ref|) ok")
                do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
                got = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
                want = A._attend_bwd_ref(q, k, v, o, do, lse, kb)
                for part, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                    self._check("flash_attention_bwd", g_, w_, *tol[dtype], f"{part} {what}")
                # every sum in a fixed order (dq's partials of the key blocks
                # in index order): a second launch gives the same bits
                again = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
                torch.cuda.synchronize()
                same = [bool(torch.equal(a_, g_)) for a_, g_ in zip(again, got)]
                log(f"  flash_attention_bwd {what} (dq over {A.dq_partials(s)} key blocks): "
                    f"two launches bit for bit equal (dq, dk, dv): {same}")
                if not all(same):
                    raise AssertionError(f"K2 is not deterministic at {what}")
                del q, k, v, o, lse, do, got, want, again

        # B*H = 70,000, past the 65,535 blocks of gridDim.y: K1 and K2 put B*H
        # on gridDim.x
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kb = attn_inputs(gen, 70000, 1, 16, 32, dtype, False, False)
            what = f"(70000, 1, 16, 32) {str(dtype)[6:]}"
            self._check("flash_attention", A.flash_attention(q, k, v), A._attend_ref(q, k, v),
                        *((2e-5, 1e-4) if dtype == torch.float32 else (1e-2, 2e-2)), what)
            o, lse = A._launch(q, k, v, None, with_lse=True)
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            got = A.flash_attention_bwd(q, k, v, o, do, lse)
            want = A._attend_bwd_ref(q, k, v, o, do, lse)
            for part, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                self._check("flash_attention_bwd", g_, w_, *tol[dtype], f"{part} {what}")
            del q, k, v, o, lse, do, got, want

        log("gradients through the Functions on CUDA vs autograd of the plain versions:")
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((2, 300, 4, 3, 32), generator=gen, device=dev).to(dtype)
            kb = torch.zeros((2, 300), device=dev)
            kb[1, 250:] = -1e9
            qkv_k = qkv.clone().requires_grad_()
            qkv_p = qkv.clone().requires_grad_()
            outs = []
            for t_, fn in ((qkv_k, A.flash_attention), (qkv_p, A._attend_ref)):
                q, k, v = (t_[:, :, :, i].transpose(1, 2) for i in range(3))
                outs.append(fn(q, k, v, kb))
            dout = torch.randn(outs[0].shape, generator=gen, device=dev).to(dtype)
            (g_k,) = torch.autograd.grad(outs[0], qkv_k, dout)
            (g_p,) = torch.autograd.grad(outs[1], qkv_p, dout)
            self._check("flash_attention_bwd", g_k, g_p, *tol[dtype],
                        f"d(qkv) through flash_attention (2, 4, 300, 32) {str(dtype)[6:]}")
            for (bsz, c, hh, ww, groups) in ((2, 256, 16, 128, 32), (2, 768, 8, 64, 32)):
                x = (torch.randn((bsz, c, hh, ww), generator=gen, device=dev) * 2 + 0.3).to(dtype)
                gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
                beta = 0.1 * torch.randn(c, generator=gen, device=dev)
                dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
                for act in (False, True):
                    grads = []
                    for fn in (G.group_norm, G._ref):
                        xs, gs, bs = (t_.clone().requires_grad_() for t_ in (x, gamma, beta))
                        grads.append(torch.autograd.grad(fn(xs, gs, bs, groups, 1e-6, act),
                                                         (xs, gs, bs), dy))
                    # both compute the backward in f32 from the same x and dy;
                    # dx is rounded to x's dtype, dgamma/dbeta sum 131K products
                    for part, g_, w_, t_ in zip(("dx", "dgamma", "dbeta"), *grads,
                                                ((1e-4, 1e-4) if dtype == torch.float32
                                                 else (2e-2, 1e-2), (1e-3, 1e-4), (1e-3, 1e-4))):
                        self._check("group_norm", g_, w_, *t_,
                                    f"{part} {(bsz, c, hh, ww)} {str(dtype)[6:]} act={act}",
                                    record=False)

    def _kernels_chamfer(self):
        """K4 against its plain version and a float64 computation: a scene
        pair, a 65,536-point pair, ragged sizes, masks (all masked gives
        BIG exactly), identical clouds (0 exactly), and clouds built to trip
        its candidate selection; two launches bit for bit; the tensor cores'
        summation held to the model K4's bound rests on; the grad guard."""
        import torch
        from lidar_layout_tpu_torch.data.synthetic import synthetic_scene
        from lidar_layout_tpu_torch.ops import chamfer as C
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
        from lidar_layout_tpu_torch.sample import range_roundtrip
        from torch_port_helpers import CHAMFER_CLOUDS, chamfer_cloud

        dev = torch.device("cuda")
        rng = np.random.default_rng(7)
        scenes = range_roundtrip([synthetic_scene(np.random.default_rng(s)) for s in (0, 1)],
                                 KITTI_GEOMETRY, "cuda")
        ragged = rng.uniform(-40, 40, (4097, 3)).astype(np.float32)
        mask = rng.random(4097) < 0.7
        cases = [("scene pair", scenes[0], scenes[1], None),
                 ("65536 x 65536 in a 100 m box",
                  rng.uniform(-50, 50, (65536, 3)).astype(np.float32),
                  rng.uniform(-50, 50, (65536, 3)).astype(np.float32), None),
                 ("13 x 77", ragged[:13], ragged[100:177], None),
                 ("1000 x 4097", ragged[:1000] + 0.5, ragged, None),
                 ("1000 x 4097 y mask", ragged[:1000] + 0.5, ragged, mask),
                 ("1000 x 4097 all masked", ragged[:1000], ragged, np.zeros(4097, bool)),
                 ("identical 4097", ragged, ragged, None)]
        # the clouds of tests/test_torch_chamfer_select.py at full size:
        # 20K-65K points a side
        cases += [(name, *chamfer_cloud(name, 20000 if name != "1 cm grid" else 65536, 11),
                   None) for name in sorted(CHAMFER_CLOUDS)]
        cases.append(("offset by 500 m, range-roundtripped scenes",
                      scenes[0] + 500.0, scenes[1] + 500.0, None))
        log("K4 chamfer_nn vs _nn_dist_ref (plain, f32 expansion) and float64; the direct "
            "forms it formed a point (over its splits) and its largest candidate error as a "
            "share of the error model (at most 1.1: K4's bound is 1.1x the model, and 4x on "
            "the tensor cores' summation term):")
        for what, xs, ys, ms in cases:
            x, y = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (xs, ys))
            m = None if ms is None else torch.from_numpy(ms).to(dev)
            before = C.nn_dist_one_way.launches
            got = C.nn_dist_one_way(x, y, m)
            again = C.nn_dist_one_way(x, y, m)
            plain = C._nn_dist_ref(x, y, m)
            d64 = C._nn_dist_ref(x.double(), y.double(), m)
            stats, direct, splits, worst = C.nn_dist_stats(x, y, m)
            torch.cuda.synchronize()
            if C.nn_dist_one_way.launches != before + 3:
                raise AssertionError("K4 did not count its launches")
            # the direct form rounds 3 differences, 3 products and 2 sums:
            # a few eps_f32 of d; the expansion cancels |x|^2 + |y|^2
            err64 = float(((got.double() - d64).abs() - 1e-6 * (1 + d64)).max())
            scale = (x.double().square().sum(1) + y.double().square().sum(1).max())
            err = (plain.double() - got.double()).abs()
            err_exp = float((err - 16 * EPS32 * scale).max())
            self.kernel_err["chamfer_nn"] = max(self.kernel_err["chamfer_nn"],
                                                float(err.max()))
            exact = True
            if what.endswith("all masked"):
                exact = bool((got == C.BIG).all())
            elif what.startswith("identical") or what == "x equal to some y":
                exact = bool((got == 0).all())
            same = bool(torch.equal(got, again)) and bool(torch.equal(got, stats))
            ok = (err64 <= 0 and err_exp <= 0 and exact and same and bool((got >= 0).all())
                  and worst <= 1.1)
            per_x = direct.double() / splits
            log(f"  {what} ({len(xs)} x {len(ys)}): max |K4 - f64| "
                f"{float((got.double() - d64).abs().max()):.3e} (tol 1e-6*(1+d)), max "
                f"|plain - K4| {float(err.max()):.3e} (tol 16 eps32 (|x|^2 + max|y|^2)), "
                f"exact={exact}, three launches bit for bit equal: {same}; {splits} splits, "
                f"direct forms a point and split mean {float(per_x.mean()):.3f} max "
                f"{float(per_x.max()):.0f}, points re-checked beyond one chunk a split "
                f"{100 * float((direct > C.RECHECK * splits).double().mean()):.2f}%; "
                f"largest candidate "
                f"error {worst:.3f} of the model's bound {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K4 {what} disagrees")
            del x, y, got, again, plain, d64, stats, direct
        x = torch.from_numpy(ragged[:100]).to(dev).requires_grad_()
        try:
            C.nn_dist_one_way(x, torch.from_numpy(ragged).to(dev))
        except RuntimeError as e:
            log(f"  grad guard raises on the card: {e}")
        else:
            raise AssertionError("K4 returned a result with no gradient for an input "
                                 "that requires grad")

    # --------------------------------------------------------- main-path shapes
    def _main_shapes(self):
        """Kernel calls of one DPM-20 request at batch 16, by shape: hooks on a
        batch-16 U-Net eval and VQ decode record them once."""
        if self.shapes is not None:
            return self.shapes
        import torch
        from lidar_layout_tpu_torch.flagship import flagship

        model, _ = flagship(dtype=torch.bfloat16)
        self.shapes, self.gn_where = self._request_shapes(model)
        del model
        torch.cuda.empty_cache()
        for name, cnt in self.shapes.items():
            log(f"main-path {name} launches per DPM-20 request (batch 16): "
                f"{sum(cnt.values())} over {len(cnt)} shapes")
        return self.shapes

    @staticmethod
    def _request_shapes(model, batch=BATCH):
        """Kernel calls of one DPM-20 request of ``model`` at ``batch`` (16)
        by shape (K1 and K3), and K3's by (shape, "unet" or "decoder"):
        hooks on one U-Net eval (counted for every eval; a patched model's
        eval calls the U-Net once a crop) and one decode."""
        import torch
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize

        seen = {"group_norm": collections.Counter(), "flash_attention": collections.Counter()}
        where = collections.Counter()
        phase = {"n": unet_evals(model, 20), "where": "unet"}

        def norm_hook(mod, args):
            b, c, h, w = args[0].shape
            key = (b, c, h, w, mod.num_groups, mod.act)
            seen["group_norm"][key] += phase["n"]
            where[key, phase["where"]] += phase["n"]

        def attn_hook(mod, args):
            b, c, h, w = args[0].shape
            seen["flash_attention"][(b, mod.num_heads, h * w, c // mod.num_heads)] += phase["n"]

        hooks = []
        for m in model.unet.modules():
            if isinstance(m, Normalize):
                hooks.append(m.register_forward_pre_hook(norm_hook))
            elif isinstance(m, SelfAttentionBlock):
                hooks.append(m.register_forward_pre_hook(attn_hook))
        for m in model.first_stage_model.decoder.modules():
            if isinstance(m, Normalize):
                hooks.append(m.register_forward_pre_hook(norm_hook))
        lh, lw, lc = model.cfg.latent_shape
        dev = next(model.parameters()).device
        with torch.inference_mode():
            z = torch.randn((batch, lh, lw, lc), device=dev)
            model.apply_model(z, torch.full((batch,), 500, device=dev))   # x21 evals
            phase.update(n=1, where="decoder")
            model.decode_first_stage(z)
        for hk in hooks:
            hk.remove()
        return seen, where

    # ------------------------------------------------------------------- slice
    def slice(self):
        import torch
        from lidar_layout_tpu_torch.flagship import flagship
        from lidar_layout_tpu_torch.models.samplers import ddim_sample

        model_gpu, _ = flagship(device="cuda")
        seed_weights(model_gpu, 0)
        model_cpu, _ = flagship(device="cpu")
        model_cpu.load_state_dict({k: v.cpu() for k, v in model_gpu.state_dict().items()})
        lh, lw, lc = model_gpu.cfg.latent_shape
        x_T = torch.randn((1, lh, lw, lc), generator=torch.Generator().manual_seed(3))
        out = {}
        for name, model, dev in (("cuda", model_gpu, "cuda"), ("cpu", model_cpu, "cpu")):
            t0 = time.perf_counter()
            with torch.inference_mode():
                z = ddim_sample(model, x_T.shape, steps=4, x_T=x_T, device=dev)
                zq = model.first_stage_model.quantize((z / model.cfg.scale_factor)
                                                      .permute(0, 3, 1, 2))[2]
                img_own = model.decode_first_stage(z)
                out[name] = (z.cpu(), zq.cpu(), img_own.cpu())
            log(f"slice on {name}: {time.perf_counter() - t0:.1f} s")
        with torch.inference_mode():   # the card's latent decoded on the CPU too
            img_cpu_same = model_cpu.decode_first_stage(out["cuda"][0])
        z_g, idx_g, img_g = out["cuda"]
        z_c, idx_c, img_c = out["cpu"]
        zerr, zscale = max_err(z_g, z_c)
        agree = float((idx_g == idx_c).float().mean())
        ierr, _ = max_err(img_g, img_cpu_same)
        mask_g, mask_c = img_g > -1.0, img_cpu_same > -1.0
        mask_agree = float((mask_g == mask_c).float().mean())
        both = mask_g & mask_c
        val_err = float((img_g - img_cpu_same).abs()[both].max()) if both.any() else 0.0
        own_agree = float(((img_g > -1.0) == (img_c > -1.0)).float().mean())
        log(f"slice: latent max_abs_err={zerr:.3e} (|z|max {zscale:.3e}); VQ index "
            f"agreement {agree:.5f}; same-latent decode: image max_abs_err={ierr:.3e}, "
            f"ray-drop mask agreement {mask_agree:.6f}, kept-pixel max_abs_err="
            f"{val_err:.3e}; own-latent decode mask agreement {own_agree:.6f}")
        # tolerances: f32 everywhere, TF32 off; the two devices sum in other
        # orders, which a 4-step sampler amplifies to ~1e-4 of |z|. The VQ
        # argmin can flip on a near-tie, so indices need only 99% agreement,
        # and a decoded pixel next to 0 in the mask channel can flip ray-drop
        if not (zerr <= 1e-3 * max(zscale, 1.0) and agree >= 0.99
                and mask_agree >= 0.999 and val_err <= 1e-3 * max(1.0, float(img_g.abs().max()))):
            raise AssertionError("card slice disagrees with the CPU slice")
        if not bool(torch.isfinite(img_g).all()):
            raise AssertionError("card slice image not finite")
        del model_gpu, model_cpu
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- train_slice
    # The two trained models: the flagship on synthetic KITTI scenes, and the
    # layout model on synthetic nusc_layout_range batches, whose layout
    # encoder trains with the U-Net. One body drives each phase for both.
    @staticmethod
    def _train_model(layout, device="cuda"):
        """The flagship or the layout model from its YAML, f32 weights."""
        from lidar_layout_tpu_torch.flagship import flagship, layout_flagship

        return (layout_flagship if layout else flagship)(device=device)[0]

    @staticmethod
    def _train_batches(layout, n, seed=6, batch=TRAIN_BATCH, device="cuda"):
        """``n`` synthetic training batches: image (B, 64, 1024, 1) for the
        flagship; image (B, 32, 1024, 1) and cond = layout (B, 13, 13) for
        the layout model."""
        from lidar_layout_tpu_torch.data.synthetic import (synthetic_layout_range_batch,
                                                           synthetic_range_batch)
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY, NUSCENES_GEOMETRY

        make, geom = ((synthetic_layout_range_batch, NUSCENES_GEOMETRY) if layout
                      else (synthetic_range_batch, KITTI_GEOMETRY))
        rng = np.random.default_rng(seed)
        return [make(rng, batch, geom, device=device) for _ in range(n)]

    def train_slice(self):
        """One training step of the full-width flagship, f32, batch 1, on the
        card and on the CPU (_train_slice)."""
        self._train_slice(layout=False)

    def _train_slice(self, layout):
        """One make_train_step at full width, f32, on the card and on the
        CPU: the same weights, batch, t and noise (drawn on the CPU), dropout
        off (the layout U-Net's 0.1 set to 0). The loss, the gradients of the
        U-Net and, for the layout model, of its layout encoder, and the
        parameters and EMA after AdamW."""
        import torch
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        name = "layout_train_slice" if layout else "train_slice"
        batch = self._train_batches(layout, 1, seed=4, batch=2 if layout else 1,
                                    device="cpu")[0]
        parts = [("U-Net", lambda k: not k.startswith("cond_stage_model."))]
        if layout:
            parts.append(("layout encoder", lambda k: k.startswith("cond_stage_model.")))
        self._slice_step(name, lambda dev: self._train_model(layout, dev), batch, parts)

    def _slice_step(self, name, make_model, batch, parts, lr=1.6e-5):
        """One make_train_step, f32, of ``make_model(device)`` on the card and
        on the CPU from the same seeded weights, batch, t and noise (drawn
        on the CPU), dropout off; compared by _compare_train_runs. ``lr``:
        the LiDM YAMLs', base 1e-6 x batch 16."""
        import torch
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        runs, sd = {}, None
        for dev in ("cuda", "cpu"):
            model = make_model(dev)
            if sd is None:
                seed_weights(model, 0)
                sd = {k: v.cpu() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(sd)
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            params = DT.trainable_params(model)
            state = DT.create_train_state(model, DT.make_optimizer(params, lr), params)
            grads = {}
            step_opt = state.optimizer.step

            def spy(step_opt=step_opt, params=params, grads=grads):
                grads.update({k: p.grad.detach().cpu().clone() for k, p in params.items()})
                return step_opt()
            state.optimizer.step = spy
            t0 = time.perf_counter()
            state, logs = DT.make_train_step(model)(
                state, {k: v.to(dev) for k, v in batch.items()},
                torch.Generator().manual_seed(11))
            runs[dev] = {"loss": float(logs["loss"]), "grad_norm": float(logs["grad_norm"]),
                         "grads": grads,
                         "params": {k: p.detach().cpu().clone() for k, p in params.items()},
                         "ema": {k: v.cpu().clone() for k, v in state.ema.params.items()}}
            log(f"{name} on {dev}: {time.perf_counter() - t0:.1f} s, loss "
                f"{runs[dev]['loss']:.6f}, grad_norm {runs[dev]['grad_norm']:.6f}")
            del model, state, params
            gc.collect()   # the train state holds reference cycles: free its card memory now
            torch.cuda.empty_cache()
        self._compare_train_runs(name, runs, lr, parts)

    @staticmethod
    def _compare_train_runs(name, runs, lr, parts):
        """A training step on the card against the CPU's (``runs``: loss,
        gradients, parameters and EMA after AdamW on each): the loss, each
        part's whole gradient (``parts``: (label, key predicate)) by its
        relative L2 error and its largest error against its largest value,
        and the parameters and EMA within 2 lr."""
        import torch

        g, c = runs["cuda"], runs["cpu"]
        loss_err = abs(g["loss"] - c["loss"])
        # tolerances: f32 on both, TF32 off; the devices sum in other orders
        # through ~50 layers forward and back
        ok = loss_err <= 1e-5 * max(1.0, abs(c["loss"]))
        logs = []
        for part, pred in parts:
            keys = [k for k in c["grads"] if pred(k)]
            diff = {k: float((g["grads"][k] - c["grads"][k]).abs().max()) for k in keys}
            num = sum(float((g["grads"][k] - c["grads"][k]).square().sum()) for k in keys)
            den = sum(float(c["grads"][k].square().sum()) for k in keys)
            gmax = max(float(c["grads"][k].abs().max()) for k in keys) if keys else 0.0
            rel = (num / max(den, 1e-30)) ** 0.5
            worst = max(diff, key=diff.get) if keys else None
            logs.append(f"{part} gradients ({len(keys)} tensors): relative L2 error "
                        f"{rel:.3e}, max_abs_err {diff.get(worst, 0.0):.3e} at {worst} (|g|max "
                        f"{gmax:.3e})")
            ok = ok and bool(keys) and rel <= 1e-4 and diff[worst] <= 1e-4 * gmax and gmax > 0
        # Adam's first update is about lr * sign(g): where a gradient is within
        # rounding of 0 the two devices may step in opposite directions, so
        # parameters and EMA may differ by up to 2 lr, on few elements
        upd = torch.cat([(g["params"][k] - c["params"][k]).abs().flatten() for k in c["params"]])
        far = float((upd > 0.01 * lr).float().mean())
        perr = float(upd.max())
        eerr = max(float((g["ema"][k] - c["ema"][k]).abs().max()) for k in c["ema"])
        log(f"{name}: loss |diff| {loss_err:.3e} (loss {c['loss']:.6f}); " + "; ".join(logs)
            + f"; parameters after AdamW: max_abs_err {perr:.3e}, share of elements off by > "
            f"0.01 lr {far:.2e}; EMA max_abs_err {eerr:.3e} (lr {lr:g})")
        ok = ok and far <= 1e-3 and perr <= 2 * lr and eerr <= 2 * lr
        if not ok:
            raise AssertionError(f"{name}: the card's training step disagrees with the CPU's")

    # -------------------------------------------------------------------- main
    def main(self):
        import torch
        from lidar_layout_tpu_torch.flagship import flagship
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline

        model, image_shape = flagship(dtype=torch.bfloat16, device="cuda")
        seed_weights(model, 0)
        card = card_line()
        n, batch = N_MAIN, BATCH
        per_eval_attn = sum(1 for m in model.unet.modules()
                            if type(m).__name__ == "SelfAttentionBlock")
        unet_norms = sum(1 for m in model.unet.modules() if type(m).__name__ == "Normalize")
        dec_norms = sum(1 for m in model.first_stage_model.decoder.modules()
                        if type(m).__name__ == "Normalize")
        for sampler, steps in (("dpm", 20), ("ddim", 50)):
            pipe = GenerationPipeline(model, KITTI_GEOMETRY, sampler=sampler, steps=steps)
            pipe.generate(batch, seed=99)        # warm-up (cuDNN plans, allocator)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = pipe.generate(n, seed=0, batch=batch)
            got = {"flash_attention": A.flash_attention.launches,
                   "group_norm": G.group_norm.launches}
            batches = n // batch
            evals = unet_evals(model, steps)
            want = {"flash_attention": batches * evals * per_eval_attn,
                    "group_norm": batches * (evals * unet_norms + dec_norms)}
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            imgs = res.images
            log(f"main {sampler}-{steps}: images {imgs.shape} finite="
                f"{bool(np.isfinite(imgs).all())} clouds={len(res.clouds)} "
                f"(median {int(np.median([len(c) for c in res.clouds]))} points); "
                f"{res.samples_per_sec:.3f} samples/s; phases "
                + ", ".join(f"{k} {v:.3f} s" for k, v in res.phase_seconds.items())
                + f"; peak memory {mem:.2f} GiB; launches {got} expected {want}; "
                f"card {card}")
            if imgs.shape != (n, *image_shape) or not np.isfinite(imgs).all() \
                    or len(res.clouds) != n:
                raise AssertionError(f"main {sampler}: bad output")
            if got != want:
                raise AssertionError(f"main {sampler}: launch counts {got} != {want}")
            if sampler == "dpm":
                self.launches = got
        del model
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------- train
    def _train_setup(self, lr, layout=False):
        """A trained model (_train_model) on the card, seeded, and its train
        state: AdamW and the EMA over the U-Net (and the layout encoder)."""
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        model = self._train_model(layout)    # f32 weights; bf16 under autocast
        seed_weights(model, 0)
        params = DT.trainable_params(model)
        state = DT.create_train_state(model, DT.make_optimizer(params, lr), params)
        return model, state

    def _train_hooks(self, model):
        """Module-hook counts of one training step: kernel calls by name and
        by shape (K2 and K3's backward run once for every call that needs
        grad; the frozen VQ encoder's run under no_grad)."""
        import torch
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize

        seen = {"flash_attention": collections.Counter(),
                "flash_attention_bwd": collections.Counter(),
                "group_norm": collections.Counter(),
                "group_norm_bwd": collections.Counter(),   # K3's backward kernel
                "chamfer_nn": collections.Counter()}       # none: training scores no CD

        def norm_hook(mod, args):
            b, c, h, w = args[0].shape
            key = (b, c, h, w, mod.num_groups, mod.act)
            seen["group_norm"][key] += 1
            if torch.is_grad_enabled():
                seen["group_norm_bwd"][key] += 1

        def attn_hook(mod, args):
            b, c, h, w = args[0].shape
            key = (b, mod.num_heads, h * w, c // mod.num_heads)
            seen["flash_attention"][key] += 1
            if torch.is_grad_enabled():
                seen["flash_attention_bwd"][key] += 1

        hooks = []
        for m in list(model.unet.modules()) + list(model.first_stage_model.encoder.modules()):
            if isinstance(m, Normalize):
                hooks.append(m.register_forward_pre_hook(norm_hook))
            elif isinstance(m, SelfAttentionBlock):
                hooks.append(m.register_forward_pre_hook(attn_hook))
        return seen, hooks

    def _train_shapes(self, layout=False):
        """Kernel calls of one training step by shape: the train (or
        layout_train) phase's hooks, or hooks on one step taken here when
        that phase did not run."""
        if layout not in self.train_shapes:
            import torch
            from lidar_layout_tpu_torch.train import diffusion_trainer as DT

            model = self._train_model(layout)   # shapes only: no seeded weights
            params = DT.trainable_params(model)
            state = DT.create_train_state(model, DT.make_optimizer(params, OVERFIT_LR), params)
            seen, hooks = self._train_hooks(model)
            DT.make_train_step(model, autocast_dtype=torch.bfloat16)(
                state, self._train_batches(layout, 1)[0],
                torch.Generator(device="cuda").manual_seed(0))
            for hk in hooks:
                hk.remove()
            self.train_shapes[layout] = seen
            del model, state
            gc.collect()
            torch.cuda.empty_cache()
        return self.train_shapes[layout]

    def train(self):
        """The flagship's training path (_train_run)."""
        self._train_run(layout=False)

    def _train_run(self, layout):
        """A training path: full width, batch 16, bf16 autocast, f32 weights,
        synthetic batches. Launches per step against module hooks (and, for
        the layout model, its structure: every U-Net norm forward and
        backward, every frozen VQ encoder norm forward), no plain GroupNorm
        backward, for the layout model non-zero finite encoder gradients,
        and a falling loss on one fixed batch."""
        import torch
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        name = "layout_train" if layout else "train"
        card = card_line()
        t0 = time.perf_counter()   # scenes projected on the card, outside the timed window
        batches = self._train_batches(layout, 3)
        torch.cuda.synchronize()
        log(f"{name}: {len(batches)} synthetic batches of {TRAIN_BATCH} scenes in "
            f"{time.perf_counter() - t0:.1f} s")
        model, state = self._train_setup(OVERFIT_LR, layout)
        step = DT.make_train_step(model, autocast_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        # one warm-up step under hooks gives the expected launches per step;
        # its encoder gradients are kept
        seen, hooks = self._train_hooks(model)
        enc_grads = {}
        step_opt = state.optimizer.step

        def spy():
            enc_grads.update({k: p.grad.detach().clone() for k, p in state.params.items()
                              if k.startswith("cond_stage_model.")})
            return step_opt()
        state.optimizer.step = spy
        reset_counts()
        state, logs = step(state, batches[0], gen)
        torch.cuda.synchronize()
        first = read_counts()
        state.optimizer.step = step_opt
        for hk in hooks:
            hk.remove()
        want = {k: sum(seen[k].values()) for k in counters()}
        self.train_shapes[layout] = seen
        step(state, batches[1], gen)              # second warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        # every GroupNorm backward must go to the kernel: count the plain one
        plain_bwd, real_bwd_ref = [0], G._group_norm_bwd_ref

        def counting_bwd_ref(*a, **k):
            plain_bwd[0] += 1
            return real_bwd_ref(*a, **k)
        G._group_norm_bwd_ref = counting_bwd_ref
        try:
            t0 = time.perf_counter()
            losses = []
            for i in range(TRAIN_STEPS):
                state, logs = step(state, batches[i % len(batches)], gen)
                losses.append((logs["loss"], logs["grad_norm"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            G._group_norm_bwd_ref = real_bwd_ref
        got = read_counts()
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = {k: v / TRAIN_STEPS for k, v in got.items()}
        timed = DT.make_train_step(model, autocast_dtype=torch.bfloat16, timed=True)
        phases = collections.Counter()
        for i in range(3):
            state, tl = timed(state, batches[i], gen)
            for k in ("encode", "fwd_bwd", "opt_ema"):
                phases[k] += tl[f"seconds_{k}"] / 3
        finite = all(bool(torch.isfinite(l_)) and bool(torch.isfinite(g_)) for l_, g_ in losses)
        extra, structure = "", None
        if layout:
            unet_norms = sum(isinstance(m, Normalize) for m in model.unet.modules())
            enc_norms = sum(isinstance(m, Normalize)
                            for m in model.first_stage_model.encoder.modules())
            structure = {k: 0 for k in counters()}
            structure.update(group_norm=unet_norms + enc_norms, group_norm_bwd=unet_norms)
            enc_norm = float(torch.linalg.vector_norm(torch.stack(
                [g_.float().norm() for g_ in enc_grads.values()]))) if enc_grads else 0.0
            enc_ok = (all(bool(torch.isfinite(g_).all()) for g_ in enc_grads.values())
                      and enc_norm > 0)
            extra = (f"; structure {structure} ({unet_norms} U-Net norms forward and backward, "
                     f"{enc_norms} in the frozen VQ encoder); encoder gradients: "
                     f"{len(enc_grads)} tensors, global norm {enc_norm:.4e}, "
                     f"non-zero and finite={enc_ok}")
        log(f"{name} (batch {TRAIN_BATCH}, bf16 autocast, f32 weights, {TRAIN_STEPS} steps): "
            f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * TRAIN_BATCH / wall:.2f} samples/s; "
            f"phases per step (synchronised): encode {phases['encode']:.4f} s, forward+backward "
            f"{phases['fwd_bwd']:.4f} s, optimizer+EMA {phases['opt_ema']:.4f} s; peak memory "
            f"{mem:.2f} GiB; launches per step {per_step} (hooks {want}; first step {first}); "
            f"plain GroupNorm backward calls {plain_bwd[0]}; "
            f"loss {float(losses[-1][0]):.5f} grad_norm {float(losses[-1][1]):.5f} "
            f"finite={finite}{extra}; card {card}")
        if per_step != {k: float(v) for k, v in want.items()} or first != want:
            raise AssertionError(f"{name}: launches per step {per_step} != hooks {want}")
        if structure is not None and want != structure:
            raise AssertionError(f"{name}: hooks {want} != structure {structure}")
        if plain_bwd[0] or not want["group_norm_bwd"]:
            raise AssertionError(f"{name}: {plain_bwd[0]} plain GroupNorm backward calls, "
                                 f"{want['group_norm_bwd']} kernel launches a step")
        if not finite:
            raise AssertionError(f"{name}: loss or gradient norm not finite")
        if layout and not enc_ok:
            raise AssertionError(f"{name}: the encoder's gradients are zero or not finite")
        if layout:
            self.layout_train_launches = got
        else:
            self.train_launches = got

        # overfit check: one fixed batch, t and noise (the generator reset
        # each step), fresh weights, lr 1e-4
        del model, state, step, timed
        gc.collect()
        model, state = self._train_setup(OVERFIT_LR, layout)
        step = DT.make_train_step(model, autocast_dtype=torch.bfloat16)
        curve = []
        for i in range(OVERFIT_STEPS + 1):
            state, logs = step(state, batches[0], torch.Generator(device="cuda").manual_seed(3))
            curve.append(float(logs["loss"]))
        ratio = curve[-1] / curve[0]
        log(f"{name} overfit ({OVERFIT_STEPS} AdamW steps at lr {OVERFIT_LR:g} on one batch): "
            f"loss step 0 {curve[0]:.5f} -> step {OVERFIT_STEPS} {curve[-1]:.5f}, ratio "
            f"{ratio:.4f}; curve {[round(c_, 5) for c_ in curve[::5]]}")
        if not curve[-1] < curve[0]:
            raise AssertionError(f"{name}: the loss on a fixed batch did not fall")
        del model, state, batches
        gc.collect()
        torch.cuda.empty_cache()

    # -------------------------------------------------------------- eval_slice
    def eval_slice(self):
        """The eval modules on the card against the CPU on the same numpy
        clouds: f32, TF32 off for matmuls and cuDNN (device phase)."""
        import torch
        from lidar_layout_tpu_torch.data.synthetic import synthetic_scene
        from lidar_layout_tpu_torch.eval import device_metrics as D
        from lidar_layout_tpu_torch.eval import metrics as M
        from lidar_layout_tpu_torch.eval.rangenet import preprocess_range_batch
        from lidar_layout_tpu_torch.eval.registry import build_range_feature_net
        from lidar_layout_tpu_torch.ops import emd as E
        from lidar_layout_tpu_torch.ops import lidar as L
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY as geom
        from lidar_layout_tpu_torch.sample import range_roundtrip

        raw = [synthetic_scene(np.random.default_rng(100 + i)) for i in range(8)]
        clouds = range_roundtrip(raw, geom, "cpu")
        ref, smp = clouds[:4], clouds[4:]
        fails = []

        # CD: K4 on the card, the plain expansion on the CPU; the expansion
        # is off by up to eps32 (|x|^2 + |y|^2) a point (1e-3 m^2 at 60 m),
        # which averages out over ~20K points. Two pairs: the CPU's side
        # grows with the pairs
        cd = {d: M.compute_cd(ref[:2], smp[:2], d) for d in ("cuda", "cpu")}
        rel = abs(cd["cuda"] - cd["cpu"]) / abs(cd["cpu"])
        log(f"eval_slice CD (2 pairs, {[len(c) for c in ref[:2] + smp[:2]]} points): card "
            f"{cd['cuda']:.9g} cpu {cd['cpu']:.9g} relative {rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            fails.append("CD")

        # EMD at N = EMD_N (the (N, N) auction matrix is 16 MB there), a
        # multiple of 1024, so emd_distance would match all of it: its
        # value is computed here from the one auction
        x, y = ref[0][:EMD_N], smp[0][:EMD_N]
        res = {}
        for d in ("cuda", "cpu"):
            xt, yt = torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)
            t0 = time.perf_counter()
            a = E.auction_match(xt, yt)
            val = float(((xt - yt[a]) ** 2).sum(dim=-1).sqrt().mean())
            res[d] = (a.cpu(), val, time.perf_counter() - t0)
        (a_g, v_g, t_g), (a_c, v_c, t_c) = res["cuda"], res["cpu"]
        dd = ((torch.from_numpy(x)[:, None] - torch.from_numpy(y)[None]) ** 2).sum(-1)
        differ = (a_g != a_c).nonzero().flatten()
        gap = (float((dd[differ, a_g[differ]] - dd[differ, a_c[differ]]).abs().max())
               if len(differ) else 0.0)
        # the assignments may differ only at near-ties: two targets whose
        # squared distances are within a few roundings of the largest one
        tie = 4 * EPS32 * float(dd.max())
        rel = abs(v_g - v_c) / v_c
        log(f"eval_slice EMD at N = {EMD_N}: card {v_g:.7g} ({t_g:.2f} s) cpu {v_c:.7g} "
            f"({t_c:.2f} s) relative {rel:.3e} (tol 1e-3); assignments differ at "
            f"{len(differ)} of {EMD_N} points, largest cost gap there {gap:.3e} m^2 "
            f"(near-tie tol {tie:.3e})")
        if not (rel <= 1e-3 and gap <= tie):
            fails.append("EMD")

        # BEV histograms and occupancy bitmaps: the same binning arithmetic
        # (IEEE division, floor) on both devices, so equal
        pts = torch.zeros((8, max(len(c) for c in clouds), 3))
        valid = torch.zeros(pts.shape[:2], dtype=torch.bool)
        for i, c in enumerate(clouds):
            pts[i, :len(c)] = torch.from_numpy(c)
            valid[i, :len(c)] = True
        stats = {}
        for d in ("cuda", "cpu"):
            p, v = pts.to(d), valid.to(d)
            stats[d] = (D.bev_hist_accumulate(p[:4], v[:4]).cpu().numpy(),
                        D.bev_hist_accumulate(p[4:], v[4:]).cpu().numpy(),
                        D.bev_occupancy_packed(p, v).cpu().numpy())
        equal = all(np.array_equal(a, b) for a, b in zip(stats["cuda"], stats["cpu"]))
        hr, hs, bits = stats["cuda"]
        jsd_dev, jsd_host = D.jsd_from_hists(hr, hs), M.compute_jsd(ref, smp)
        mmd_dev, mmd_host = D.mmd_from_packed(bits[:4], bits[4:]), M.compute_mmd(ref, smp)
        log(f"eval_slice device_metrics: histograms and bitmaps card == cpu: {equal}; JSD "
            f"from card histograms {jsd_dev:.9g} vs compute_jsd {jsd_host:.9g} (tol 1e-6); "
            f"MMD from card bitmaps {mmd_dev:.9g} vs compute_mmd {mmd_host:.9g} (equal)")
        if not (equal and abs(jsd_dev - jsd_host) <= 1e-6 and mmd_dev == mmd_host):
            fails.append("device_metrics")

        # RangeNet (DarkNet21) at 64x1024: f32 on both, TF32 off; the devices
        # sum in other orders through 40 convolutions
        imgs = preprocess_range_batch(clouds, geom)
        feats = {}
        for d in ("cuda", "cpu"):
            net = build_range_feature_net("64", device=d)
            with torch.inference_mode():
                feats[d] = np.concatenate([
                    net(torch.from_numpy(imgs[i:i + 4]).to(d), return_final_logits=True)
                    .cpu().numpy() for i in (0, 4)])
        rel_l2 = float(np.linalg.norm(feats["cuda"] - feats["cpu"]) / np.linalg.norm(feats["cpu"]))
        frid = {d: M.frechet_distance(f[:4].astype(np.float64), f[4:].astype(np.float64))
                for d, f in feats.items()}
        frid_rel = abs(frid["cuda"] - frid["cpu"]) / abs(frid["cpu"])
        log(f"eval_slice RangeNet features (8 images, 64x1024): relative L2 {rel_l2:.3e} "
            f"(tol 1e-4); FRID card {frid['cuda']:.9g} cpu {frid['cpu']:.9g} relative "
            f"{frid_rel:.3e} (tol 1e-3)")
        if not rel_l2 <= 1e-4:
            fails.append("RangeNet")
        if not frid_rel <= 1e-3:
            fails.append("FRID")
        # the device-side RangeNet input from a model-space image, same on both
        model_img, _ = L.process_scan(L.pcd2range(torch.from_numpy(raw[0])[None], geom)[0], geom)
        rin = {d: D.rangenet_input_from_model_imgs(model_img.to(d), geom).cpu() for d in
               ("cuda", "cpu")}
        rin_err = float((rin["cuda"] - rin["cpu"]).abs().max())
        log(f"eval_slice rangenet_input_from_model_imgs card vs cpu: max_abs_err {rin_err:.3e} "
            f"(tol 1e-3: exp2 of up to 5.84 on each device)")
        if not rin_err <= 1e-3:
            fails.append("rangenet_input_from_model_imgs")
        fails += self._eval_slice_voxel(raw, clouds)
        if fails:
            raise AssertionError(f"eval_slice: card and CPU disagree on {fails}")

    def _eval_slice_voxel(self, raw, clouds):
        """MinkowskiNet and SPVCNN (FSVD, FPVD) at the registry's full config
        on 8 range-roundtripped clouds, card against CPU: the grid pyramid
        integer for integer, the descriptors of the first 2 clouds
        (VOXEL_DESC_TOL; the CPU's nets took 6.3-8.7 s over 8 clouds, cut to
        2 for the smoke's time); then the device twin from range2pcd's points
        on the card against the host path on the same 8 clouds
        (VOXEL_TWIN_TOL, and 1e-3 on the Fréchet distances). Returns what
        failed."""
        import torch
        from lidar_layout_tpu_torch.eval import device_metrics as D
        from lidar_layout_tpu_torch.eval import metrics as M
        from lidar_layout_tpu_torch.eval import registry as R
        from lidar_layout_tpu_torch.eval.sparse_seg_nets import build_pyramid
        from lidar_layout_tpu_torch.ops import lidar as L
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY as geom

        fails = []
        batch = R.pad_clouds(clouds)
        inputs = D.voxel_feature_inputs(*batch, R.MAX_POINTS, R.SEG_NET_CFG.voxel_size)
        pyr = {}
        for d in ("cuda", "cpu"):
            grids, p2v = build_pyramid(inputs[0].to(d), inputs[3].to(d), R.SEG_NET_CFG)
            pyr[d] = [t.cpu() for g in grids for t in g] + [p2v.cpu()]
        same = all(torch.equal(a, b) for a, b in zip(pyr["cuda"], pyr["cpu"]))
        used = [int(m.sum(1).max()) for m in pyr["cuda"][2:15:3]]
        log(f"eval_slice voxel pyramid (8 clouds, {[int(n) for n in inputs[3].sum(1)]} points) "
            f"card == cpu, codes, coords, masks and point-to-voxel: {same}; most voxels a level "
            f"{used} of {[R.SEG_NET_CFG.level_capacity(lvl) for lvl in range(5)]}")
        if not same:
            fails.append("voxel pyramid")
        nets = {}
        for modality, metric in (("voxel", "FSVD"), ("point_voxel", "FPVD")):
            desc, secs = {}, {}
            for d, n in (("cuda", len(clouds)), ("cpu", 2)):
                nets[modality, d] = fn = R.build_voxel_feature_net("64", modality, device=d)
                t0 = time.perf_counter()
                desc[d] = fn(*(t[:n].to(d) for t in batch)).cpu().numpy()
                secs[d] = time.perf_counter() - t0
            rel = float(np.linalg.norm(desc["cuda"][:2] - desc["cpu"])
                        / np.linalg.norm(desc["cpu"]))
            fd = M.frechet_distance(desc["cuda"][:4].astype(np.float64),
                                    desc["cuda"][4:].astype(np.float64))
            hashes = {nets[modality, d].param_hash for d in ("cuda", "cpu")}
            log(f"eval_slice {R.MODALITY2MODEL[modality]} descriptors (card 8 x 768 in "
                f"{secs['cuda']:.3f} s, cpu the first 2 in {secs['cpu']:.3f} s): relative L2 "
                f"{rel:.3e} (tol {VOXEL_DESC_TOL:g}); {metric} on the card {fd:.9g}; param_hash "
                f"{sorted(hashes)}")
            if not (rel <= VOXEL_DESC_TOL and np.isfinite(desc["cuda"]).all()
                    and np.isfinite(fd) and len(hashes) == 1):
                fails.append(f"{metric} descriptors")

        # the device twin: range2pcd's (B, H*W) points and validity on the card
        pts = torch.from_numpy(np.stack(raw)).to("cuda")
        xyz, valid = L.range2pcd(L.process_scan(L.pcd2range(pts, geom)[0], geom)[0], geom)
        twin = D.make_voxel_descriptor_fn(nets["voxel", "cuda"], nets["point_voxel", "cuda"],
                                          group=len(raw))
        got = [t.cpu().numpy() for t in twin(xyz, valid)]
        host_clouds = [x[v] for x, v in zip(xyz.cpu().numpy(), valid.cpu().numpy())]
        for (modality, metric), g in zip((("voxel", "FSVD"), ("point_voxel", "FPVD")), got):
            host = R.build_feature_fn("64", modality, device="cuda", feat_batch=len(raw))(
                host_clouds)
            rel = float(np.linalg.norm(g - host) / np.linalg.norm(host))
            fd = [M.frechet_distance(f[:4].astype(np.float64), f[4:].astype(np.float64))
                  for f in (g, host)]
            fd_rel = abs(fd[0] - fd[1]) / abs(fd[1])
            log(f"eval_slice device twin {metric}: descriptors relative L2 {rel:.3e} against "
                f"the host path (tol {VOXEL_TWIN_TOL:g}), {metric} {fd[0]:.9g} vs {fd[1]:.9g} "
                f"relative {fd_rel:.3e} (tol 1e-3)")
            if not (rel <= VOXEL_TWIN_TOL and fd_rel <= 1e-3):
                fails.append(f"{metric} device twin")
        del nets, twin
        torch.cuda.empty_cache()
        return fails

    # -------------------------------------------------------------------- eval
    def eval(self):
        """The sample-and-evaluate path at full width, through the port's
        entry points; then the device-side statistics against the host's."""
        import torch
        from lidar_layout_tpu_torch.data.synthetic import synthetic_scene
        from lidar_layout_tpu_torch.eval import device_metrics as D
        from lidar_layout_tpu_torch.eval.metrics import frechet_distance
        from lidar_layout_tpu_torch.eval.registry import build_feature_fn
        from lidar_layout_tpu_torch.flagship import flagship
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.ops import lidar as L
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY as geom
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline
        from lidar_layout_tpu_torch.sample import evaluate_samples, range_roundtrip

        model, _ = flagship(dtype=torch.bfloat16, device="cuda")
        seed_weights(model, 0)
        pipe = GenerationPipeline(model, geom, sampler="dpm", steps=20)
        feature_fn = build_feature_fn("64", "range", device="cuda")
        feature_fns = {"frid": feature_fn,
                       "fsvd": build_feature_fn("64", "voxel", device="cuda"),
                       "fpvd": build_feature_fn("64", "point_voxel", device="cuda")}
        reference = [synthetic_scene(np.random.default_rng(1000 + i)) for i in range(N_MAIN)]
        evals = unet_evals(model, 20)
        batches = N_MAIN // BATCH
        want = {"flash_attention": batches * evals * sum(
                    isinstance(m, SelfAttentionBlock) for m in model.unet.modules()),
                "flash_attention_bwd": 0,
                "group_norm_bwd": 0,
                "group_norm": batches * (
                    evals * sum(isinstance(m, Normalize) for m in model.unet.modules())
                    + sum(isinstance(m, Normalize)
                          for m in model.first_stage_model.decoder.modules())),
                "chamfer_nn": 2 * N_MAIN}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = pipe.generate(N_MAIN, seed=0, batch=BATCH)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = evaluate_samples(res.clouds, reference, EVAL_METRICS, "cuda", feature_fns,
                               verbose=True)
        t_eval = time.perf_counter() - t0
        got = read_counts()
        ref = range_roundtrip(reference, geom, "cuda")   # the clouds evaluate_samples scored
        self.eval_clouds = (ref, res.clouds)
        self.eval_launches = got
        n_ref, n_smp = [len(c) for c in ref], [len(c) for c in res.clouds]
        log(f"eval: generate({N_MAIN}) DPM-20 batch {BATCH} bf16 {t_gen:.3f} s, evaluate "
            f"{t_eval:.3f} s; metrics {json.dumps(out)}; points per reference cloud "
            f"min/median/max {min(n_ref)}/{int(np.median(n_ref))}/{max(n_ref)}, per sample "
            f"{min(n_smp)}/{int(np.median(n_smp))}/{max(n_smp)}; launches {got} expected "
            f"{want}; param_hash {({k: f.param_hash for k, f in feature_fns.items()})}; "
            f"card {card_line()}")
        self._voxel_inputs_log("reference", ref, raw=[len(c) for c in reference])
        self._voxel_inputs_log("sample", res.clouds)
        if got != want:
            raise AssertionError(f"eval: launch counts {got} != {want}")
        if set(out) != set(EVAL_METRICS) or not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"eval: metrics {out}")

        # the device twin: per generated batch (and per reference batch) the
        # JSD histogram, the packed MMD bitmaps and the FRID features from the
        # model-space images, read back; then the host tails. Faulty twins
        # show what the FRID limit tells from the twin (FRID_TWIN_TOL)
        net = feature_fn.net

        def rangenet_inputs(imgs):
            rin = D.rangenet_input_from_model_imgs(imgs, geom)
            depth = rin[..., :1]
            return {"twin": rin, "depth in model space": torch.cat(
                        [torch.where(depth == -1.0, depth, imgs[..., None]), rin[..., 1:]], -1),
                    "one row off": torch.roll(rin, 1, dims=1),       # logged only
                    "one column off": torch.roll(rin, 1, dims=2)}    # logged only

        def featurize(imgs):
            xyz, valid = L.range2pcd(imgs, geom)
            with torch.inference_mode():
                feats = {k: net(r, return_final_logits=True).cpu().numpy()
                         for k, r in rangenet_inputs(imgs).items()}
            return (D.bev_hist_accumulate(xyz, valid).cpu().numpy(),
                    D.bev_occupancy_packed(xyz, valid).cpu().numpy(), feats)

        t0 = time.perf_counter()
        twin = {"ref": [], "smp": []}
        for i in range(0, N_MAIN, BATCH):
            imgs = torch.from_numpy(res.images[i:i + BATCH, ..., 0]).to("cuda")
            twin["smp"].append(featurize(imgs))
            pts = torch.from_numpy(np.stack(reference[i:i + BATCH])).to("cuda")
            model_img, _ = L.process_scan(L.pcd2range(pts, geom)[0], geom)
            twin["ref"].append(featurize(model_img))
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t0
        hist = {k: sum(b[0] for b in v) for k, v in twin.items()}
        bits = {k: np.concatenate([b[1] for b in v]) for k, v in twin.items()}
        jsd = D.jsd_from_hists(hist["ref"], hist["smp"])
        mmd = D.mmd_from_packed(bits["ref"], bits["smp"])
        frid_rel = {}
        for name in twin["ref"][0][2]:   # the twin, then the faulty twins
            feats = {k: np.concatenate([b[2][name] for b in v]).astype(np.float64)
                     for k, v in twin.items()}
            frid = frechet_distance(feats["ref"], feats["smp"])
            frid_rel[name] = abs(frid - out["frid"]) / abs(out["frid"])
            log(f"eval device twin FRID ({name}) {frid:.9g} vs host {out['frid']:.9g}, "
                f"relative {frid_rel[name]:.3e} (the twin within {FRID_TWIN_TOL:g}, "
                f"{' and '.join(FRID_FAULTS)} beyond it)")
        log(f"eval device twin ({t_twin:.3f} s for {2 * N_MAIN} clouds): JSD {jsd:.9g} vs host "
            f"{out['jsd']:.9g} (tol 1e-6); MMD {mmd:.9g} vs host {out['mmd']:.9g} (equal)")
        if not (abs(jsd - out["jsd"]) <= 1e-6 and mmd == out["mmd"]
                and frid_rel["twin"] <= FRID_TWIN_TOL
                < min(frid_rel[name] for name in FRID_FAULTS)):
            raise AssertionError("eval: the device-side statistics disagree with the host's, "
                                 "or the FRID limit does not tell a faulty twin from the twin")
        del model, pipe, net, feature_fn, feature_fns
        torch.cuda.empty_cache()

    @staticmethod
    def _voxel_inputs_log(name, clouds, raw=None):
        """What FSVD/FPVD's nets see of each cloud, as the JAX package defines
        them: points before and after the 30000 cap, the share of kept points
        whose voxel coords pass 1023 (their codes clip), distinct cells, and
        voxels per pyramid level against its capacity (an overflow merges
        into the level's last row); ``raw``, the points before a range round
        trip."""
        import torch
        from lidar_layout_tpu_torch.eval import device_metrics as D
        from lidar_layout_tpu_torch.eval import registry as R
        from lidar_layout_tpu_torch.eval.sparse_seg_nets import build_pyramid

        vox, _, _, mask = D.voxel_feature_inputs(
            *(t.to("cuda") for t in R.pad_clouds(clouds)), R.MAX_POINTS,
            R.SEG_NET_CFG.voxel_size)
        past = [float((v[m] > 1023).any(-1).float().mean()) for v, m in zip(vox, mask)]
        cells = [len(torch.unique(v[m], dim=0)) for v, m in zip(vox, mask)]
        grids, _ = build_pyramid(vox, mask, R.SEG_NET_CFG)

        def spread(xs):
            return f"{min(xs):.6g}/{float(np.median(xs)):.6g}/{max(xs):.6g}"

        levels = "; ".join(
            f"L{lvl} {spread(g.mask.sum(1).tolist())} of {g.mask.shape[1]} "
            f"(full in {int((g.mask.sum(1) == g.mask.shape[1]).sum())})"
            for lvl, g in enumerate(grids))
        log(f"eval voxel inputs, {len(clouds)} {name} clouds (min/median/max): "
            + (f"raw points {spread(raw)}, roundtripped " if raw else "")
            + f"points {spread([len(c) for c in clouds])}, kept "
            f"{spread(mask.sum(1).tolist())} (cap {R.MAX_POINTS}); share of kept points past "
            f"1023 cells {spread(past)}; distinct cells {spread(cells)}; voxels a level: "
            f"{levels}; card {card_line()}")

    # ------------------------------------------------------- layout-path shapes
    def _layout_shapes(self):
        """K3 calls of one layout request (DPM-20, batch 16) by (shape, origin):
        the U-Net at batch 16 ("unet cfg 1") and at the guided request's
        doubled batch 32 ("unet cfg 2"), and the decoder ("decoder"); hooks on
        one eval of each record them."""
        if self.layout_shapes is not None:
            return self.layout_shapes
        import torch
        from lidar_layout_tpu_torch.flagship import layout_flagship
        from lidar_layout_tpu_torch.models.samplers import _tree_cat
        from lidar_layout_tpu_torch.nn.blocks import Normalize

        model, _ = layout_flagship(dtype=torch.bfloat16)
        seen = collections.Counter()
        phase = {"n": unet_evals(model, 20), "where": "unet cfg 1"}

        def norm_hook(mod, args):
            b, c, h, w = args[0].shape
            seen[(b, c, h, w, mod.num_groups, mod.act), phase["where"]] += phase["n"]

        hooks = [m.register_forward_pre_hook(norm_hook)
                 for part in (model.unet, model.first_stage_model.decoder)
                 for m in part.modules() if isinstance(m, Normalize)]
        lh, lw, lc = model.cfg.latent_shape
        with torch.inference_mode():
            cond = model.get_learned_conditioning(np.zeros((BATCH, 13, 13), np.float32))
            z = torch.randn((BATCH, lh, lw, lc), device="cuda")
            t = torch.full((BATCH,), 500, device="cuda")
            model.apply_model(z, t, cond)        # one eval, counted for each of a request's
            phase["where"] = "unet cfg 2"
            model.apply_model(torch.cat([z, z]), torch.cat([t, t]), _tree_cat(cond, cond))
            phase.update(n=1, where="decoder")
            model.decode_first_stage(z)
        for hk in hooks:
            hk.remove()
        del model
        torch.cuda.empty_cache()
        self.layout_shapes = seen
        for origin in ("unet cfg 1", "unet cfg 2", "decoder"):
            cnt = {k: n for (k, o), n in seen.items() if o == origin}
            log(f"layout-path K3 launches per DPM-20 request (batch {BATCH}), {origin}: "
                f"{sum(cnt.values())} over {len(cnt)} shapes")
        return seen

    # ------------------------------------------------------------ layout_slice
    def layout_slice(self):
        """The full-width layout model, f32, batch 2, seeded weights: layout
        encoding, guided DDIM-4 and decode on the card (K3) and on the CPU
        (plain versions), from the same x_T and layouts."""
        import torch
        from lidar_layout_tpu_torch.data.synthetic import synthetic_layouts
        from lidar_layout_tpu_torch.flagship import layout_flagship
        from lidar_layout_tpu_torch.models.samplers import ddim_sample
        from lidar_layout_tpu_torch.ops.lidar import NUSCENES_GEOMETRY

        model_gpu, _ = layout_flagship(device="cuda")
        seed_weights(model_gpu, 0)
        model_cpu, _ = layout_flagship(device="cpu")
        model_cpu.load_state_dict({k: v.cpu() for k, v in model_gpu.state_dict().items()})
        layouts = synthetic_layouts(np.random.default_rng(7), 2, NUSCENES_GEOMETRY)
        lh, lw, lc = model_gpu.cfg.latent_shape
        x_T = torch.randn((2, lh, lw, lc), generator=torch.Generator().manual_seed(3))
        out = {}
        for name, model, dev in (("cuda", model_gpu, "cuda"), ("cpu", model_cpu, "cpu")):
            t0 = time.perf_counter()
            with torch.inference_mode():
                c = model.get_learned_conditioning(layouts)
                u = model.get_learned_conditioning(np.zeros_like(layouts))
                z = ddim_sample(model, x_T.shape, steps=4, cond=c, uncond=u,
                                cfg_scale=LAYOUT_CFG_SCALE, x_T=x_T, device=dev)
                zq = model.first_stage_model.quantize((z / model.cfg.scale_factor)
                                                      .permute(0, 3, 1, 2))[2]
                img = model.decode_first_stage(z)
                out[name] = ({k: v.cpu() for k, v in c.items()}, z.cpu(), zq.cpu(), img.cpu())
            log(f"layout_slice on {name}: {time.perf_counter() - t0:.1f} s")
        with torch.inference_mode():   # the card's latent decoded on the CPU too
            img_cpu_same = model_cpu.decode_first_stage(out["cuda"][1])
        (c_g, z_g, idx_g, img_g), (c_c, z_c, idx_c, _) = out["cuda"], out["cpu"]
        cerr = max(max_err(c_g[k], c_c[k])[0] / max(1.0, max_err(c_g[k], c_c[k])[1])
                   for k in c_c if c_c[k].dtype != torch.bool)
        mask_same = bool(torch.equal(c_g["key_padding_mask"], c_c["key_padding_mask"]))
        zerr, zscale = max_err(z_g, z_c)
        agree = float((idx_g == idx_c).float().mean())
        ierr, iscale = max_err(img_g, img_cpu_same)
        log(f"layout_slice: encoder outputs max err/max(1, |ref|max) {cerr:.3e}, padding mask "
            f"equal {mask_same}; latent max_abs_err={zerr:.3e} (|z|max {zscale:.3e}); VQ "
            f"index agreement {agree:.5f}; same-latent decode: image max_abs_err={ierr:.3e} "
            f"(|img|max {iscale:.3e})")
        # the slice phase's tolerances (f32, TF32 off, other summation orders
        # amplified by the sampler; VQ near-ties may flip an index); the
        # encoder, one transformer with no sampler behind it, to 1e-4
        if not (cerr <= 1e-4 and mask_same and zerr <= 1e-3 * max(zscale, 1.0)
                and agree >= 0.99 and ierr <= 1e-3 * max(1.0, iscale)):
            raise AssertionError("card layout slice disagrees with the CPU slice")
        if not bool(torch.isfinite(img_g).all()) or img_g.shape != (2, 32, 1024, 1):
            raise AssertionError(f"card layout slice image {tuple(img_g.shape)} not finite "
                                 f"or of the wrong shape")
        del model_gpu, model_cpu
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------ layout
    def layout(self):
        """Serving the layout-conditioned model at full width through the
        entry points a user calls: from_config, get_learned_conditioning,
        generate with cond, uncond and cfg_scale."""
        import torch
        from lidar_layout_tpu_torch.data.synthetic import synthetic_layouts
        from lidar_layout_tpu_torch.flagship import LAYOUT_YAML
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline

        pipe = GenerationPipeline.from_config(LAYOUT_YAML, dataset="32", bf16=True)
        model = pipe.model
        seed_weights(model, 0)   # else the zero-initialised projections leave layouts unread
        card = card_line()
        n, batch = N_MAIN, BATCH
        layouts = synthetic_layouts(np.random.default_rng(11), n, pipe.geom)
        with torch.inference_mode():
            cond = model.get_learned_conditioning(layouts)
            uncond = model.get_learned_conditioning(np.zeros((batch, 13, 13), np.float32))
        unet_norms = sum(isinstance(m, Normalize) for m in model.unet.modules())
        dec_norms = sum(isinstance(m, Normalize)
                        for m in model.first_stage_model.decoder.modules())
        hooked = collections.Counter()
        hooks = [m.register_forward_pre_hook(lambda mod, args: hooked.update(["gn"]))
                 for part in (model.unet, model.first_stage_model.decoder)
                 for m in part.modules() if isinstance(m, Normalize)]
        first = {k: v[:batch] for k, v in cond.items()}
        for sampler, steps, scale in (("dpm", 20, 1.0), ("dpm", 20, LAYOUT_CFG_SCALE),
                                      ("ddim", 50, 1.0), ("ddim", 50, LAYOUT_CFG_SCALE)):
            pipe.sampler, pipe.steps = sampler, steps
            u = uncond if scale != 1.0 else None
            pipe.generate(batch, seed=99, batch=batch, cond=first, uncond=u, cfg_scale=scale)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            hooked.clear()
            res = pipe.generate(n, seed=0, batch=batch, cond=cond, uncond=u, cfg_scale=scale)
            got = read_counts()
            evals = unet_evals(model, steps)
            want = {name: 0 for name in got}
            want["group_norm"] = (n // batch) * (evals * unet_norms + dec_norms)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            imgs = res.images
            log(f"layout {sampler}-{steps} cfg_scale {scale:g}: images {imgs.shape} finite="
                f"{bool(np.isfinite(imgs).all())} clouds={len(res.clouds)} (median "
                f"{int(np.median([len(c) for c in res.clouds]))} points); "
                f"{res.samples_per_sec:.3f} samples/s; phases "
                + ", ".join(f"{k} {v:.3f} s" for k, v in res.phase_seconds.items())
                + f"; peak memory {mem:.2f} GiB; launches {got} expected {want}, module hooks "
                f"saw {hooked['gn']} K3 calls; card {card}")
            if imgs.shape != (n, 32, 1024, 1) or not np.isfinite(imgs).all() \
                    or len(res.clouds) != n:
                raise AssertionError(f"layout {sampler} cfg_scale {scale:g}: bad output")
            if got != want or hooked["gn"] != got["group_norm"]:
                raise AssertionError(f"layout {sampler} cfg_scale {scale:g}: launch counts "
                                     f"{got} != {want} (hooks {hooked['gn']})")
            if (sampler, scale) == ("dpm", LAYOUT_CFG_SCALE):
                self.layout_launches = got
        for hk in hooks:
            hk.remove()
        # the same x_T under two pairs of layouts: every image differs
        pipe.sampler, pipe.steps = "dpm", 20
        pair = [pipe.generate(2, seed=5, batch=2, cond={k: v[i:i + 2] for k, v in cond.items()},
                              uncond={k: v[:2] for k, v in uncond.items()},
                              cfg_scale=LAYOUT_CFG_SCALE).images for i in (0, 2)]
        diff = np.abs(pair[0] - pair[1]).reshape(2, -1).max(axis=1)
        log(f"layout: same x_T, layouts 0-1 against 2-3: per-image max |difference| {diff}")
        if not (diff > 1e-3).all():
            raise AssertionError("layout: different layouts gave the same image")
        del model, pipe, cond, uncond
        torch.cuda.empty_cache()

    # ----------------------------------------------------- layout training
    def layout_train_slice(self):
        """One training step of the full-width layout model, f32, batch 2,
        on the card and on the CPU (_train_slice)."""
        self._train_slice(layout=True)

    def layout_train(self):
        """The layout model's training path, its encoder trained with the
        U-Net (_train_run)."""
        self._train_run(layout=True)

    # ------------------------------------------------------ LayoutDiffusion
    @staticmethod
    def _box_graph(seed):
        from lidar_layout_tpu_torch.data.layout_synthetic import synthetic_graph_batch
        from lidar_layout_tpu_torch.sample_layout import MAX_OBJS, MAX_TRIPLES

        return synthetic_graph_batch(np.random.default_rng(seed), n_scenes=BOX_SCENES,
                                     max_objs_per_scene=MAX_OBJS,
                                     max_triples_per_scene=MAX_TRIPLES)

    def _box_attention_count(self):
        """K1 calls of one LayoutDiffusion request: the layout_boxes phase's
        module hooks, or hooks on one request taken here when that phase
        did not run."""
        if self.box_attention_calls is None:
            import torch
            from lidar_layout_tpu_torch.nn.attention import CrossAttention
            from lidar_layout_tpu_torch.sample_layout import build_model, sample_layouts

            model = build_model(device="cuda")
            seed_weights(model, 0)
            hooked = [0]

            def hook(mod, args):
                hooked[0] += 1
            hooks = [m.register_forward_pre_hook(hook)
                     for m in model.unet.modules() if isinstance(m, CrossAttention)]
            sample_layouts(model, self._box_graph(11), BOX_STEPS, seed=0)
            for hk in hooks:
                hk.remove()
            self.box_attention_calls = hooked[0]
            del model
            torch.cuda.empty_cache()
        return self.box_attention_calls

    def layout_boxes_slice(self):
        """The full-width LayoutDiffusion, f32, on the card (K1) and on the
        CPU (plain versions): the same seeded weights, graph, change noise
        and x_T; the encoder's two outputs, one U-Net eval, DDIM-4."""
        import torch
        from lidar_layout_tpu_torch.sample_layout import build_model

        graph = self._box_graph(7)
        n = graph["dec_objs"].shape[0]
        cpu_gen = torch.Generator().manual_seed(3)
        change = torch.randn((n, 64), generator=cpu_gen)
        x_T = torch.randn((n, 8), generator=cpu_gen)
        box_t = torch.randn((n, 8), generator=cpu_gen)
        t = torch.randint(0, 1000, (n,), generator=cpu_gen)
        out, sd = {}, None
        for dev in ("cuda", "cpu"):
            model = build_model(device=dev)
            if sd is None:
                seed_weights(model, 0)
                sd = {k: v.cpu() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(sd)
            t0 = time.perf_counter()
            with torch.inference_mode():
                latent, obj = model.encode_graph(graph, change_noise=change)
                g = {k: torch.as_tensor(np.asarray(graph[k])).to(dev)
                     for k in ("dec_triples", "dec_pred_mask")}
                eps = model.apply_model(box_t.to(dev), t.to(dev), obj, g["dec_triples"].long(),
                                        latent, g["dec_pred_mask"])
                boxes = model.ddim_sample(graph, steps=4, x_T=x_T, change_noise=change)
            out[dev] = [v.cpu() for v in (latent, obj, eps, boxes)]
            log(f"layout_boxes_slice on {dev}: {time.perf_counter() - t0:.1f} s")
            del model
            torch.cuda.empty_cache()
        errs = {}
        for name, a, b in zip(("latent", "obj_embed", "unet eval", "DDIM-4 boxes"),
                              out["cuda"], out["cpu"]):
            err, scale = max_err(a, b)
            errs[name] = (err, scale, err / max(1.0, scale))
        log("layout_boxes_slice: " + "; ".join(
            f"{k} max_abs_err {e:.3e} (|ref|max {s:.3e}, {r:.3e} of max(1, |ref|max))"
            for k, (e, s, r) in errs.items()))
        # f32 on both, TF32 off: the encoder's 10 graph convs and one U-Net
        # eval sum in other orders (1e-4 of their scale); DDIM-4 amplifies
        # that, as the slice phase's sampler does (1e-3)
        tol = {"latent": 1e-4, "obj_embed": 1e-4, "unet eval": 1e-4, "DDIM-4 boxes": 1e-3}
        bad = [k for k, (_, _, r) in errs.items() if not r <= tol[k]]
        if bad or not all(bool(torch.isfinite(v).all()) for v in out["cuda"]):
            raise AssertionError(f"card LayoutDiffusion slice disagrees with the CPU: {bad}")
        if errs["unet eval"][1] == 0:
            raise AssertionError("layout_boxes_slice: the U-Net's output is all zeros")

    def layout_boxes(self):
        """Serving LayoutDiffusion through sample_layout's path: build_model
        from the YAML, sample_layouts over 16 scenes x 16 objects, DDIM-100."""
        import torch
        from lidar_layout_tpu_torch.nn.attention import CrossAttention
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.sample_layout import build_model, sample_layouts

        card = card_line()
        model = build_model(device="cuda")
        seed_weights(model, 0)   # else the zero-initialised projections leave graphs unread
        graph = self._box_graph(11)
        n = graph["dec_objs"].shape[0]
        per_eval = sum(isinstance(m, CrossAttention) for m in model.unet.modules())
        structure = {name: 0 for name in counters()}
        structure["flash_attention"] = per_eval * BOX_STEPS
        hooked = collections.Counter()
        hooks = [m.register_forward_pre_hook(lambda mod, args: hooked.update(["attn"]))
                 for m in model.unet.modules() if isinstance(m, CrossAttention)]
        plain = collections.Counter()
        real = {name: getattr(A, name) for name in ("_attend_ref", "_dot_product_attention")}

        def counting(name):
            def fn(*a, **k):
                plain[name] += 1
                return real[name](*a, **k)
            return fn
        sample_layouts(model, graph, BOX_STEPS, seed=99)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for name in real:
            setattr(A, name, counting(name))
        try:
            for call in range(BOX_CALLS):
                reset_counts()
                hooked.clear()
                t0 = time.perf_counter()
                res = sample_layouts(model, graph, BOX_STEPS, seed=call)
                wall = time.perf_counter() - t0       # ends in the copy to the host
                got = read_counts()
                rates.append((BOX_SCENES / wall, n / wall, wall))
                log(f"layout_boxes call {call}: {BOX_SCENES} scenes ({n} boxes), DDIM-"
                    f"{BOX_STEPS}, f32: {wall:.3f} s, {BOX_SCENES / wall:.3f} scenes/s, "
                    f"{n / wall:.1f} boxes/s; launches {got} (structure {structure}: "
                    f"{per_eval} CrossAttentions x {BOX_STEPS} U-Net evals; module hooks "
                    f"{hooked['attn']})")
                if got != structure or hooked["attn"] != got["flash_attention"]:
                    raise AssertionError(f"layout_boxes: launches {got} != structure "
                                         f"{structure} (hooks {hooked['attn']})")
        finally:
            for name, fn in real.items():
                setattr(A, name, fn)
            for hk in hooks:
                hk.remove()
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        boxes = res["boxes"]
        log(f"layout_boxes: boxes {boxes.shape} finite={bool(np.isfinite(boxes).all())}; plain "
            f"attention calls {dict(plain)}; peak memory {mem:.2f} GiB; scenes/s over "
            f"{BOX_CALLS} calls {[round(r[0], 3) for r in rates]}; card {card}")
        if boxes.shape != (n, 7) or not np.isfinite(boxes).all() or n != 256:
            raise AssertionError(f"layout_boxes: bad boxes {boxes.shape}")
        if sum(plain.values()):
            raise AssertionError(f"layout_boxes: plain attention ran {dict(plain)}")
        self.layout_boxes_launches = got
        self.box_attention_calls = hooked["attn"]
        # two graphs under the same x_T: different boxes
        x_T = torch.randn((n, 8), generator=torch.Generator().manual_seed(5))
        pair = [sample_layouts(model, self._box_graph(s), BOX_STEPS, seed=5, x_T=x_T)["boxes"]
                for s in (11, 12)]
        diff = np.abs(pair[0] - pair[1]).max()
        log(f"layout_boxes: same x_T, graphs of seeds 11 and 12: max |box difference| {diff:.4e}")
        if not diff > 1e-3:
            raise AssertionError("layout_boxes: different graphs gave the same boxes")
        del model
        torch.cuda.empty_cache()

    # --------------------------------------------- LayoutDiffusion training
    @staticmethod
    def _box_train_model(device="cuda", lr=BOX_LR):
        """LayoutDiffusion from its YAML with the seeded weights, f32, and
        its train state: AdamW with clipping and the EMA over every
        parameter."""
        from lidar_layout_tpu_torch.sample_layout import build_model
        from lidar_layout_tpu_torch.train import layout_trainer as LT

        model = build_model(device=device)
        seed_weights(model, 0)   # else the zero-initialised projections leave graphs unread
        return model, LT.create_layout_train_state(model, lr)

    @staticmethod
    def _write_box_infos(root, n=24, seed=0):
        """A tiny nuScenes layout infos pickle (train split) of n scene
        graphs of 6-20 objects and 10-40 relations, no CLIP features."""
        import pickle

        rng = np.random.default_rng(seed)
        names = ["car", "truck", "bus", "pedestrian", "barrier", "traffic_cone", "bicycle"]
        infos = []
        for _ in range(n):
            k, r = int(rng.integers(6, 21)), int(rng.integers(10, 41))
            boxes = np.stack([rng.uniform(-45, 45, k), rng.uniform(-45, 45, k),
                              rng.uniform(-3, 1, k), rng.uniform(0.5, 8, k),
                              rng.uniform(0.5, 3, k), rng.uniform(0.5, 4, k),
                              rng.uniform(-np.pi, np.pi, k)], 1).astype(np.float32)
            rel = np.stack([rng.integers(0, k + 1, r), rng.integers(0, 16, r),
                            rng.integers(0, k + 1, r)], 1).tolist()
            infos.append({"scene_graph": {"keep_box": boxes, "keep_box_relationships": rel,
                                          "keep_box_names": [names[j] for j in
                                                             rng.integers(0, len(names), k)]}})
        with open(os.path.join(root, "nuscenes_infos_train.pkl"), "wb") as f:
            pickle.dump(infos, f)

    def layout_boxes_train_slice(self):
        """One LayoutDiffusion training step at full width, f32, 16 scenes x
        16 objects, on the card and on the CPU: the same seeded weights,
        graph, change noise, t and noise, through make_layout_train_step
        (dropout off, as JAX's training). The loss, the U-Net1D's and the
        scene-graph encoder's whole gradients, the parameters and EMA after
        AdamW (_compare_train_runs), and to_q/to_k's gradients (0 with one
        key)."""
        import torch
        from lidar_layout_tpu_torch.train import layout_trainer as LT

        name = "layout_boxes_train_slice"
        graph = self._box_graph(7)
        n = graph["dec_objs"].shape[0]
        cpu_gen = torch.Generator().manual_seed(3)
        draws = {"change_noise": torch.randn((n, 64), generator=cpu_gen),
                 "t_scene": torch.randint(0, 1000, (BOX_SCENES,), generator=cpu_gen),
                 "noise": torch.randn((n, 8), generator=cpu_gen)}
        runs = {}
        for dev in ("cuda", "cpu"):
            model, state = self._box_train_model(dev)   # the same seeded weights on both
            grads, step_opt = {}, state.optimizer.step

            def spy(step_opt=step_opt, params=state.params, grads=grads):
                grads.update({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                              .detach().cpu().clone() for k, p in params.items()})
                return step_opt()
            state.optimizer.step = spy
            t0 = time.perf_counter()
            state, logs = LT.make_layout_train_step(model)(state, graph, None, **draws)
            runs[dev] = {"loss": float(logs["loss"]), "grads": grads,
                         "params": {k: p.detach().cpu().clone() for k, p in state.params.items()},
                         "ema": {k: v.cpu().clone() for k, v in state.ema.params.items()}}
            qk = max(float(g_.abs().max()) for k, g_ in grads.items()
                     if k.endswith(("to_q.weight", "to_k.weight")))
            log(f"{name} on {dev}: {time.perf_counter() - t0:.1f} s, loss "
                f"{runs[dev]['loss']:.6f}, grad_norm {float(logs['grad_norm']):.6f}, largest "
                f"|gradient| of the 44 to_q/to_k weights {qk:.3e}")
            if qk:
                raise AssertionError(f"{name} on {dev}: to_q/to_k gradients are not 0 with one key")
            del model, state
            gc.collect()   # the train state holds reference cycles: free its card memory now
            torch.cuda.empty_cache()
        self._compare_train_runs(name, runs, BOX_LR,
                                 [("U-Net1D", lambda k: k.startswith("unet.")),
                                  ("scene-graph encoder", lambda k: k.startswith("cond_stage."))])

    def layout_boxes_train(self):
        """train_layout's path at 16 scenes x 16 objects, f32: synthetic
        graphs at the dataset's capacity and one batch read from a tiny
        infos pickle through the data factory; two warm-ups and TRAIN_STEPS timed
        steps (steps/s, scenes/s, phase split, peak memory), K1 and K2
        launches per step against the structure (every CrossAttention
        forward and backward) and module hooks, no plain attention, non-zero
        finite encoder gradients, a fixed-batch overfit check; then the CLI
        itself (--synthetic --steps 1: one step and a 3 GB checkpoint; two
        were cut for the smoke's time) and sample_layout -r on its run."""
        import shutil
        import tempfile

        import torch
        from lidar_layout_tpu_torch import sample_layout as SL
        from lidar_layout_tpu_torch.data.factory import build_batches
        from lidar_layout_tpu_torch.nn.attention import CrossAttention
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.train import layout_trainer as LT
        from lidar_layout_tpu_torch.train import train_layout as TL

        name, card = "layout_boxes_train", card_line()
        tmp = tempfile.mkdtemp(prefix="layout_boxes_train_")
        try:
            self._write_box_infos(tmp)
            read = next(build_batches("nusc_layout_graph", {"with_changes": True}, {}, tmp,
                                      BOX_SCENES, seed=1))
            batches = [self._box_graph(20 + i) for i in range(3)] + [read]
            log(f"{name}: batches of {BOX_SCENES} scenes: 3 synthetic, 1 read from a "
                f"{len(read['obj_mask'])}-slot infos pickle ({int(read['obj_mask'].sum())} "
                f"objects, {int(read['dec_pred_mask'].sum())} triples)")
            model, state = self._box_train_model()
            step = LT.make_layout_train_step(model)
            gen = torch.Generator(device="cuda").manual_seed(0)
            attns = [m for m in model.unet.modules() if isinstance(m, CrossAttention)]
            structure = {k: 0 for k in counters()}
            structure.update(flash_attention=len(attns), flash_attention_bwd=len(attns))
            seen = collections.Counter()

            def hook(mod, args):
                seen["flash_attention"] += 1
                seen["flash_attention_bwd"] += int(torch.is_grad_enabled())
            hooks = [m.register_forward_pre_hook(hook) for m in attns]
            enc_grads, step_opt = {}, state.optimizer.step

            def spy():
                enc_grads.update({k: p.grad.detach().clone() for k, p in state.params.items()
                                  if k.startswith("cond_stage.") and p.grad is not None})
                return step_opt()
            state.optimizer.step = spy
            plain = collections.Counter()
            real = {n_: getattr(A, n_) for n_ in ("_attend_ref", "_lse_ref", "_attend_bwd_ref",
                                                  "_dot_product_attention")}

            def counting(n_):
                def fn(*a, **k):
                    plain[n_] += 1
                    return real[n_](*a, **k)
                return fn
            for n_ in real:
                setattr(A, n_, counting(n_))
            try:
                reset_counts()
                state, logs = step(state, batches[0], gen)          # warm-up 1, hooked
                torch.cuda.synchronize()
                first = read_counts()
                hooked = {k: seen.get(k, 0) for k in structure}
                state.optimizer.step = step_opt
                for hk in hooks:
                    hk.remove()
                step(state, batches[1], gen)                        # warm-up 2
                torch.cuda.synchronize()
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                losses = []
                for i in range(TRAIN_STEPS):
                    state, logs = step(state, batches[i % len(batches)], gen)
                    losses.append((logs["loss"], logs["grad_norm"]))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for n_, fn in real.items():
                    setattr(A, n_, fn)
            got = read_counts()
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            per_step = {k: v / TRAIN_STEPS for k, v in got.items()}
            timed = LT.make_layout_train_step(model, timed=True)
            phases = collections.Counter()
            for i in range(3):
                state, tl = timed(state, batches[i], gen)
                for k in ("fwd_bwd", "opt_ema"):
                    phases[k] += tl[f"seconds_{k}"] / 3
            finite = all(bool(torch.isfinite(l_)) and bool(torch.isfinite(g_))
                         for l_, g_ in losses)
            enc_norm = float(torch.linalg.vector_norm(torch.stack(
                [g_.norm() for g_ in enc_grads.values()]))) if enc_grads else 0.0
            enc_ok = enc_norm > 0 and all(bool(torch.isfinite(g_).all())
                                          for g_ in enc_grads.values())
            log(f"{name} ({BOX_SCENES} scenes x 16 objects, f32, {TRAIN_STEPS} steps): "
                f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * BOX_SCENES / wall:.2f} scenes/s;"
                f" phases per step (synchronised): forward+backward {phases['fwd_bwd']:.4f} s, "
                f"optimizer+EMA {phases['opt_ema']:.4f} s; peak memory {mem:.2f} GiB; launches "
                f"per step {per_step} (structure {structure}: {len(attns)} CrossAttentions "
                f"forward and backward; hooks {hooked}; first step {first}); plain attention "
                f"calls {dict(plain)}; encoder gradients: {len(enc_grads)} tensors, global norm "
                f"{enc_norm:.4e}, non-zero and finite={enc_ok}; loss {float(losses[-1][0]):.5f} "
                f"grad_norm {float(losses[-1][1]):.5f} finite={finite}; card {card}")
            if per_step != {k: float(v) for k, v in structure.items()} or first != structure \
                    or hooked != structure:
                raise AssertionError(f"{name}: launches per step {per_step} (first {first}, "
                                     f"hooks {hooked}) != structure {structure}")
            if sum(plain.values()):
                raise AssertionError(f"{name}: plain attention ran {dict(plain)}")
            if not finite or not enc_ok:
                raise AssertionError(f"{name}: loss or gradients not finite, or the encoder's "
                                     f"gradients are zero")
            self.layout_boxes_train_launches = got
            del model, state, step, timed
            gc.collect()

            # overfit check: one fixed batch, t, noise and change noise (the
            # generator reset each step), fresh weights, lr 1e-4
            model, state = self._box_train_model(lr=OVERFIT_LR)
            step = LT.make_layout_train_step(model)
            curve = []
            for i in range(OVERFIT_STEPS + 1):
                state, logs = step(state, batches[0], torch.Generator(device="cuda").manual_seed(3))
                curve.append(float(logs["loss"]))
            log(f"{name} overfit ({OVERFIT_STEPS} AdamW steps at lr {OVERFIT_LR:g} on one batch): "
                f"loss step 0 {curve[0]:.5f} -> step {OVERFIT_STEPS} {curve[-1]:.5f}, ratio "
                f"{curve[-1] / curve[0]:.4f}; curve {[round(c_, 5) for c_ in curve[::5]]}")
            if not curve[-1] < curve[0]:
                raise AssertionError(f"{name}: the loss on a fixed batch did not fall")
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()

            # the CLI on the card, then sample_layout from its run directory
            run = os.path.join(tmp, "run")
            t0 = time.perf_counter()
            trainer = TL.main(["--synthetic", "--steps", "1", "--workdir", run])
            log(f"{name}: train_layout --synthetic --steps 1 in {time.perf_counter() - t0:.1f} s "
                f"on {next(trainer.state.model.parameters()).device}; run files "
                f"{sorted(os.listdir(run))}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            out = SL.main(["-r", run, "-n", str(BOX_SCENES), "--steps", "10", "--outdir",
                           os.path.join(tmp, "samples")])
            boxes = out["boxes"]
            log(f"{name}: sample_layout -r <run> -n {BOX_SCENES} --steps 10: boxes {boxes.shape} "
                f"finite={bool(np.isfinite(boxes).all())}")
            if boxes.shape != (BOX_SCENES * 16, 7) or not np.isfinite(boxes).all():
                raise AssertionError(f"{name}: sample_layout from the run gave bad boxes")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- ae_train_slice
    @staticmethod
    def _ae_setup(device="cuda", lr=AE_LR, seed=0, yaml_path=AE_YAML, accumulate=1,
                  overrides=()):
        """An autoencoder YAML's VQModel (the kitti one unless ``yaml_path``;
        dotlist ``overrides`` applied), its loss config and geometry, and
        JAX's discriminator (v1, 64 filters, 3 layers, as the CLI builds
        it), seeded weights (the same on every device), two Adams: (model,
        disc, loss_cfg, geo, state)."""
        from lidar_layout_tpu_torch.config import apply_dotlist, instantiate_from_config, load_yaml
        from lidar_layout_tpu_torch.losses.discriminator import LiDARNLayerDiscriminator
        from lidar_layout_tpu_torch.losses.geometric import GeoConverter
        from lidar_layout_tpu_torch.pipeline import geometry_from_config
        from lidar_layout_tpu_torch.train import ae_trainer as AT

        cfg = apply_dotlist(load_yaml(yaml_path), list(overrides))
        loss_cfg = instantiate_from_config(cfg["model"]["params"]["lossconfig"])
        geo = GeoConverter(geometry_from_config(cfg), curve_length=loss_cfg.curve_length)
        model = seed_weights(instantiate_from_config(cfg["model"]), seed).to(device)
        disc = seed_weights(LiDARNLayerDiscriminator(
            AT.disc_in_channels(model.cfg.out_ch, loss_cfg, geo)), seed + 1).to(device)
        return model, disc, loss_cfg, geo, AT.create_ae_state(model, disc, lr, lr, accumulate)

    @staticmethod
    def _ae_batches(n, seed=6, device="cuda", yaml_path=AE_YAML, overrides=()):
        """``n`` synthetic batches of AE_BATCH scenes in an AE YAML's
        geometry (after ``overrides``): image (B, 64, 1024, 1) for the kitti
        YAML."""
        from lidar_layout_tpu_torch.config import apply_dotlist, load_yaml
        from lidar_layout_tpu_torch.data.synthetic import synthetic_range_batch
        from lidar_layout_tpu_torch.pipeline import geometry_from_config

        rng = np.random.default_rng(seed)
        geom = geometry_from_config(apply_dotlist(load_yaml(yaml_path), list(overrides)))
        return [synthetic_range_batch(rng, AE_BATCH, geom, device=device) for _ in range(n)]

    @staticmethod
    def _ae_structure(model, disc):
        """K3 launches of one AE step from the structure: every autoencoder
        norm forward and backward; each discriminator norm forward three
        times (the reconstruction in the generator pass, then real and
        reconstruction), backward four times (the reconstruction's twice:
        the adaptive weight's GAN gradient and the loss's)."""
        from lidar_layout_tpu_torch.losses.discriminator import GroupNorm32
        from lidar_layout_tpu_torch.nn.blocks import Normalize

        n_ae = sum(isinstance(m, Normalize) for m in model.modules())
        n_disc = sum(isinstance(m, GroupNorm32) for m in disc.modules())
        out = {k: 0 for k in counters()}
        out.update(group_norm=n_ae + 3 * n_disc, group_norm_bwd=n_ae + 4 * n_disc)
        return out, n_ae, n_disc

    def _ae_shapes(self):
        """K3's calls of one AE training step by shape, (forward, backward)
        Counters keyed (B, C, H, W, groups, act, eps): the ae_train phase's
        hooks, or hooks on one step taken here when it did not run."""
        if self.ae_shapes is None:
            import torch
            from torch_port_helpers import count_group_norms

            model, disc, loss_cfg, geo, state = self._ae_setup()
            with count_group_norms(model, disc) as shapes:
                ae_step(model, disc, loss_cfg, geo)(
                    state, self._ae_batches(1)[0], torch.Generator(device="cuda").manual_seed(0))
            self.ae_shapes = shapes
            del model, disc, state
            gc.collect()
            torch.cuda.empty_cache()
        return self.ae_shapes

    def _kernels_ae(self, shapes=None, key="ae", label="the AE's training step",
                    forward_twice=False, dtype=None):
        """K3 forward and backward in f32 (or ``dtype``) at every group shape
        of one AE training step (encoder, decoder, discriminator; eps 1e-6,
        and 1e-5 in the discriminator), against the plain versions; the
        backward bit for bit over two launches, and with ``forward_twice``
        the forward too. ``shapes`` (forward, backward) Counters of another
        model's step; the errors go to ``<key>_group_norm``. In bf16 both
        round the output (and dx) to bf16: the kernels phase's bf16
        tolerances."""
        import torch
        from lidar_layout_tpu_torch.ops import groupnorm as G

        dtype = dtype or torch.float32
        f32 = dtype == torch.float32
        name = str(dtype)[6:]
        fwd, bwd = self._ae_shapes() if shapes is None else shapes
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(9)
        log(f"K3 forward and backward, {name}, at every group shape of {label} "
            f"({len(set(fwd) | set(bwd))} shapes; batch {AE_BATCH}):")
        for (b, c, hh, ww, groups, act, eps) in sorted(set(fwd) | set(bwd)):
            x = (torch.randn((b, c, hh, ww), generator=gen, device=dev) * 2 + 0.3).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
            beta = 0.1 * torch.randn(c, generator=gen, device=dev)
            dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            span_kb = c // groups * hh * ww * x.element_size() / 1024
            what = (f"{(b, c, hh, ww)} G={groups} act={act} eps={eps:g} {name} ({span_kb:g} KB "
                    f"groups; paths: forward "
                    f"{path_name(G.kernel_path(dtype, c, hh * ww, groups))}, backward "
                    f"{path_name(G.kernel_path(dtype, c, hh * ww, groups, True))})")
            got = G.group_norm(x, gamma, beta, groups, eps, act)
            want = G._ref(x, gamma, beta, groups, eps, act)
            self._check("group_norm", got, want, *((1e-4, 1e-5) if f32 else (2e-2, 1e-2)),
                        what, record=False)
            self.kernel_err[f"{key}_group_norm"] = max(
                self.kernel_err.get(f"{key}_group_norm", 0.0), max_err(got, want)[0])
            if forward_twice and not torch.equal(got, G.group_norm(x, gamma, beta, groups,
                                                                   eps, act)):
                raise AssertionError(f"K3's forward is not deterministic at {what}")
            got = G.group_norm_bwd(x, gamma, beta, dy, groups, eps, act)
            want = G._group_norm_bwd_ref(x, gamma, beta, dy, groups, eps, act)
            for part, g_, w_, t_ in zip(("dx", "dgamma", "dbeta"), got, want,
                                        ((1e-4, 1e-4) if f32 else (2e-2, 1e-2), (1e-3, 1e-4),
                                         (1e-3, 1e-4))):
                self._check("group_norm_bwd", g_, w_, *t_, f"{part} {what}", record=False)
                self.kernel_err[f"{key}_group_norm_bwd"] = max(
                    self.kernel_err.get(f"{key}_group_norm_bwd", 0.0), max_err(g_, w_)[0])
            again = G.group_norm_bwd(x, gamma, beta, dy, groups, eps, act)
            torch.cuda.synchronize()
            if not all(torch.equal(a_, g_) for a_, g_ in zip(again, got)):
                raise AssertionError(f"K3's backward is not deterministic at {what}")
            del x, dy, got, want, again
        torch.cuda.empty_cache()

    def ae_train_slice(self):
        """One VQ-GAN step of the full-width kitti autoencoder at batch 4,
        f32 (TF32 off), on the card and on the CPU from the same weights and
        batch, at step 0 (GAN terms on). Step 2, past disc_start 1 with the
        GAN terms off (20.9 s of CPU), is left out for the smoke's time:
        coarse_slice's AE holds it under the same gates. The batch stays 4
        scenes of 64x1024: on one scene, or on 32x256 images, d_weight reads
        1.8e-4 and 2.0e-4 apart on the two devices, past its gate:
        every loss part, d_weight and disc_loss, the generator's and the
        discriminator's gradients by relative L2, and both models after
        Adam; on the card, K3's launches against the structure and hooks.
        At step 0 a control runs the card's step again with TF32 on for
        matmuls and cuDNN: the same gates must find it not correct."""
        self._ae_slice("ae_train_slice", AE_YAML, tf32_control=True, steps=(0,))

    def _ae_slice(self, name, yaml_path, tf32_control, overrides=(), steps=(0, 2)):
        """ae_train_slice's steps 0 and 2 (or ``steps``) for an AE YAML
        (dotlist ``overrides`` applied), card against CPU, with the TF32
        control at step 0 when ``tf32_control``."""
        import torch
        from torch_port_helpers import count_group_norms

        from lidar_layout_tpu_torch.models.autoencoder_gaus import VQModelGaus

        batch = self._ae_batches(1, seed=4, device="cpu", yaml_path=yaml_path,
                                 overrides=overrides)[0]
        failed = []   # both steps are compared and logged before a failure is raised
        for step_no in steps:
            runs = {}
            control = step_no == 0 and tf32_control
            for run in ("cuda", "cuda_tf32", "cpu") if control else ("cuda", "cpu"):
                dev = run.split("_")[0]
                model, disc, loss_cfg, geo, state = self._ae_setup(dev, yaml_path=yaml_path,
                                                                   overrides=overrides)
                state.step = step_no
                grads = {}
                for part, opt, module in (("generator", state.opt_g, model),
                                          ("discriminator", state.opt_d, disc)):
                    def spy(gs, real=opt.step, part=part, module=module):
                        grads.update({f"{part}.{n}": g_.detach().cpu().clone()
                                      for (n, _), g_ in zip(module.named_parameters(), gs)})
                        return real(gs)
                    opt.step = spy
                structure, n_ae, n_disc = self._ae_structure(model, disc)
                s2 = isinstance(model, VQModelGaus)
                reset_counts()
                t0 = time.perf_counter()
                tf32 = run == "cuda_tf32"
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    with count_group_norms(model, disc) as (fwd, bwd):
                        state, logs = ae_step(model, disc, loss_cfg, geo)(
                            state, {k: v.to(dev) for k, v in batch.items()},
                            torch.Generator(device=dev))
                        if dev == "cuda":
                            torch.cuda.synchronize()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
                launches = read_counts()
                hooked = {**{k: 0 for k in counters()}, "group_norm": sum(fwd.values()),
                          "group_norm_bwd": sum(bwd.values())}
                runs[run] = {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads,
                             "params": {f"{p_}.{n}": t_.detach().cpu().clone()
                                        for p_, m in (("generator", model),
                                                      ("discriminator", disc))
                                        for n, t_ in m.named_parameters()}}
                log(f"{name} step {step_no} on {run}: {time.perf_counter() - t0:.1f} s; "
                    + ", ".join(f"{k} {v:.6g}" for k, v in sorted(runs[run]["logs"].items())))
                if dev == "cuda":
                    log(f"{name} step {step_no} ({run}): K3 launches {launches}, hooks "
                        f"{hooked}, structure {structure} ({n_ae} autoencoder norms, {n_disc} "
                        f"in the discriminator)")
                    if not launches == hooked == structure:
                        raise AssertionError(f"{name}: K3 launches differ from the "
                                             f"structure or the hooks")
                del model, disc, state
                gc.collect()
                torch.cuda.empty_cache()
            if not self._compare_ae_runs(step_no, "f32", runs["cuda"], runs["cpu"], name, s2):
                failed.append(step_no)
            if control and self._compare_ae_runs(step_no, "TF32 control",
                                                 runs["cuda_tf32"], runs["cpu"], name, s2):
                raise AssertionError(f"{name}: the gates pass the card's step with TF32 on; "
                                     f"they cannot tell it from f32")
        if failed:
            raise AssertionError(f"{name} steps {failed}: the card's AE step disagrees with "
                                 f"the CPU's")

    @staticmethod
    def _compare_ae_runs(step_no, label, g, c, name="ae_train_slice", s2=False):
        """The card's AE step ``g`` against the CPU's ``c`` (f32 on both;
        the two sum in other orders through ~60 layers forward and back):
        True when it agrees. Fixed gates, set from the f32 runs with room on
        both sides (the card read d_weight 4.3e-6, the generator's gradients
        1.1e-4 at step 0 and 1.0e-5 at step 2, the discriminator's 1.8e-5;
        PERF.md section 6), which TF32 must fail. Every logged loss part
        within 1e-5 relative, except d_weight, held to 1e-4: it reads the
        norm of the GAN loss's gradient for conv_out's weight, whose sums
        over B*H*W = 262,144 products cancel. The gradients by relative L2:
        the discriminator's within 1e-4; the generator's within 3e-4 at step
        0, where the GAN term's gradient (d_weight times the discriminator's
        backward) adds its cancellation, and 1e-4 at step 2, since the
        weight gradients of its 64x1024 convolutions sum 262,144 products a
        weight, which cuDNN's and oneDNN's wgrad add in other orders; the
        three tensors with the largest share of the error are logged. Both
        models after Adam within 2 lr and the rounding of the parameter
        (the first update is about lr * sign(g), which flips where g is
        within rounding of 0), under 1e-3 of the elements off by more than
        0.01 lr. With ``s2`` (the Gaussian AE) two gates are wider: its
        Gaussian tower's gradients pass through the rasterizer's alpha
        thresholds (the card read 1.2e-4-5.6e-4 relative L2 in its heads at
        steps 0 and 2), and its adaptive weight is 6.3 at step 0 (kitti's
        1.3), which scales the GAN term's cancellation: the card read the
        generator's gradients 8.4e-4 with the GAN terms on, 1.2e-5 off, and
        1.3e-3-1.6e-3 of the elements off after Adam. So 2e-3 with the GAN
        on and a share of 3e-3; the TF32 control must still fail them."""
        import torch

        rel = {k: abs(g["logs"][k] - c["logs"][k]) / max(abs(c["logs"][k]), 1e-30)
               for k in c["logs"]}
        gan_on = c["logs"]["disc_loss"] != 0
        ok = rel["d_weight"] <= 1e-4 and all(
            v <= 1e-5 or abs(g["logs"][k] - c["logs"][k]) <= 1e-7
            for k, v in rel.items() if k != "d_weight")
        parts = []
        gen_on = 2e-3 if s2 else 3e-4
        for part, tol in (("generator", gen_on if gan_on else 1e-4), ("discriminator", 1e-4)):
            keys = [k for k in c["grads"] if k.startswith(part)]
            err = {k: float((g["grads"][k] - c["grads"][k]).square().sum()) for k in keys}
            num = sum(err.values())
            den = sum(float(c["grads"][k].square().sum()) for k in keys)
            r = (num / den) ** 0.5 if den else num ** 0.5
            worst = ", ".join(
                f"{k} {err[k] / max(num, 1e-300):.2f} (own relative L2 "
                f"{(err[k] / max(float(c['grads'][k].square().sum()), 1e-300)) ** 0.5:.1e})"
                for k in sorted(err, key=err.get, reverse=True)[:3])
            groups = collections.defaultdict(lambda: [0.0, 0.0])
            for k in keys:
                top = ".".join(k.split(".")[1:3] if k.split(".")[1] == "gaus_decoder"
                               else k.split(".")[1:2])
                groups[top][0] += err[k]
                groups[top][1] += float(c["grads"][k].square().sum())
            by = ", ".join(f"{m} {(e / max(d, 1e-300)) ** 0.5:.1e}"
                           for m, (e, d) in sorted(groups.items()))
            parts.append(f"{part} gradients ({len(keys)} tensors): relative L2 {r:.3e} "
                         f"(tol {tol:.0e}); by module {by}; largest shares of the error: "
                         f"{worst}")
            ok = ok and bool(keys) and r <= tol and (den > 0) == (part == "generator" or gan_on)
        upd = torch.cat([(g["params"][k] - c["params"][k]).abs().flatten() for k in c["params"]])
        pmax = max(float(t_.abs().max()) for t_ in c["params"].values())
        far = float((upd > 0.01 * AE_LR).float().mean())
        share = 3e-3 if s2 else 1e-3
        ok = ok and float(upd.max()) <= 2 * AE_LR + 2 * EPS32 * pmax and far <= share
        log(f"{name} step {step_no} {label} (GAN terms {'on' if gan_on else 'off'}): "
            f"{'correct' if ok else 'NOT correct'}; relative errors "
            + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rel.items()))
            + " (tol d_weight 1e-4, others 1e-5); " + "; ".join(parts)
            + f"; parameters after Adam: max_abs_err {float(upd.max()):.3e}, share off by > "
            f"0.01 lr {far:.2e} (tol {share:.0e}; lr {AE_LR:g})")
        return ok

    # ---------------------------------------------------------------- ae_train
    def ae_train(self):
        """The autoencoder's training path: the kitti YAML at full width,
        batch 4, f32 with TF32 off, synthetic scenes. Two warm-ups (the
        first under hooks), TRAIN_STEPS timed steps: steps/s, samples/s, peak memory,
        K3's launches a step against the structure and hooks, no plain
        GroupNorm; the phase split over 3 synchronised steps; a falling
        rec_loss over OVERFIT_STEPS steps on one batch; then the CLI on the kitti and
        nuScenes YAMLs (--synthetic --steps 2), and the kitti run's
        checkpoint as the flagship LiDM's first stage, decoding."""
        self.ae_train_launches, self.ae_shapes = self._ae_train_run("ae_train", AE_YAML)
        self._ae_cli()

    def _ae_train_run(self, name, yaml_path, accumulate=1, overfit=True, steps=TRAIN_STEPS,
                      split_steps=3):
        """ae_train's ``steps`` timed steps (and, with ``overfit``, its
        overfit check) for an AE YAML, its phase split over ``split_steps``
        synchronised steps: (launches over the timed steps, K3's (forward,
        backward) calls of one step by shape)."""
        import torch
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from torch_port_helpers import count_group_norms

        card = card_line()
        t0 = time.perf_counter()
        batches = self._ae_batches(3, yaml_path=yaml_path)
        torch.cuda.synchronize()
        log(f"{name}: {len(batches)} synthetic batches of {AE_BATCH} scenes in "
            f"{time.perf_counter() - t0:.1f} s")
        model, disc, loss_cfg, geo, state = self._ae_setup(yaml_path=yaml_path,
                                                           accumulate=accumulate)
        step = ae_step(model, disc, loss_cfg, geo)
        gen = torch.Generator(device="cuda").manual_seed(0)
        structure, n_ae, n_disc = self._ae_structure(model, disc)
        reset_counts()
        with count_group_norms(model, disc) as shapes:
            state, logs = step(state, batches[0], gen)           # warm-up 1, hooked
            torch.cuda.synchronize()
        first = read_counts()
        hooked = {**{k: 0 for k in counters()}, "group_norm": sum(shapes[0].values()),
                  "group_norm_bwd": sum(shapes[1].values())}
        step(state, batches[1], gen)                              # warm-up 2
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        plain, real = collections.Counter(), (G._ref, G._group_norm_bwd_ref)

        def counting(n_, fn):
            def wrapped(*a, **k):
                plain[n_] += 1
                return fn(*a, **k)
            return wrapped
        G._ref, G._group_norm_bwd_ref = (counting("_ref", real[0]),
                                         counting("_group_norm_bwd_ref", real[1]))
        try:
            t0 = time.perf_counter()
            losses = []
            for i in range(steps):
                state, logs = step(state, batches[i % len(batches)], gen)
                losses.append((logs["total_loss"], logs["rec_loss"], logs["d_weight"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            G._ref, G._group_norm_bwd_ref = real
        got = read_counts()
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = {k: v / steps for k, v in got.items()}
        timed = ae_step(model, disc, loss_cfg, geo, timed=True)
        phases = collections.Counter()
        for i in range(split_steps):
            state, tl = timed(state, batches[i], gen)
            for k in ("gen", "disc", "opt"):
                phases[k] += tl[f"seconds_{k}"] / split_steps
        finite = all(bool(torch.isfinite(torch.stack(v)).all()) for v in losses)
        log(f"{name} ({os.path.relpath(yaml_path, HERE)}, batch {AE_BATCH}, accumulate "
            f"{accumulate}, f32, TF32 off, "
            f"{steps} steps): {steps / wall:.3f} steps/s, "
            f"{steps * AE_BATCH / wall:.2f} samples/s; phases per step (synchronised): "
            f"generator forward+backward with the adaptive weight {phases['gen']:.4f} s, "
            f"discriminator {phases['disc']:.4f} s, both Adams {phases['opt']:.4f} s; peak "
            f"memory {mem:.2f} GiB; launches per step {per_step} (structure {structure}: "
            f"{n_ae} autoencoder norms, {n_disc} discriminator norms; hooks {hooked}; first "
            f"step {first}); plain GroupNorm calls {dict(plain)}; last total_loss "
            f"{float(losses[-1][0]):.5f} rec_loss {float(losses[-1][1]):.5f} d_weight "
            f"{float(losses[-1][2]):.5f} finite={finite}; card {card}")
        if (per_step != {k: float(v) for k, v in structure.items()} or first != structure
                or hooked != structure):
            raise AssertionError(f"{name}: launches per step {per_step} (first {first}, hooks "
                                 f"{hooked}) != structure {structure}")
        if sum(plain.values()) or not finite:
            raise AssertionError(f"{name}: plain GroupNorm ran {dict(plain)}, or a loss is "
                                 f"not finite")
        del model, disc, state, step, timed
        gc.collect()
        if not overfit:
            torch.cuda.empty_cache()
            return got, shapes

        # overfit check: one fixed batch, fresh weights, lr 1e-4
        model, disc, loss_cfg, geo, state = self._ae_setup(lr=OVERFIT_LR, yaml_path=yaml_path)
        step = ae_step(model, disc, loss_cfg, geo)
        curve = []
        for i in range(OVERFIT_STEPS + 1):
            state, logs = step(state, batches[0], gen)
            curve.append(float(logs["rec_loss"]))
        log(f"{name} overfit ({OVERFIT_STEPS} Adam steps at lr {OVERFIT_LR:g} on one batch; GAN "
            f"terms on at steps 0-1): rec_loss step 0 {curve[0]:.5f} -> step {OVERFIT_STEPS} "
            f"{curve[-1]:.5f}, ratio {curve[-1] / curve[0]:.4f}; curve "
            f"{[round(c_, 5) for c_ in curve[::5]]}")
        if not curve[-1] < curve[0]:
            raise AssertionError(f"{name}: rec_loss on a fixed batch did not fall")
        del model, disc, state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
        return got, shapes

    def _ae_cli(self):
        """train_lidm --synthetic --steps 2 on the kitti and nuScenes AE
        YAMLs (full width, on the card), then the kitti run's checkpoint
        read by load_first_stage_params as the flagship LiDM's first stage
        (the LiDM YAML with the AE YAML's ddconfig, codebook and mask
        setting: the AE YAML trains a 1-channel decoder, the LiDM YAML names
        a 2-channel one; ROADMAP section 3) and two decoded images. The
        kitti run stays for the ae_eval phase (``self.ae_run``)."""
        import shutil

        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
        from lidar_layout_tpu_torch.train import checkpoint as CK
        from lidar_layout_tpu_torch.train import train_lidm as TL

        tmp = self.tmp_dir("ae_train_")
        try:
            for data, yaml_path in (("kitti", AE_YAML), ("nuscenes", AE_NUSC_YAML)):
                run = os.path.join(tmp, data)
                t0 = time.perf_counter()
                trainer = TL.main(["-b", yaml_path, "--synthetic", "--steps", "2",
                                   "--workdir", run])
                dev = next(trainer.state.model.parameters()).device
                log(f"ae_train: train_lidm -b {os.path.relpath(yaml_path, HERE)} --synthetic "
                    f"--steps 2 in {time.perf_counter() - t0:.1f} s on {dev}; run files "
                    f"{sorted(os.listdir(run))}")
                if trainer.global_step != 2 or dev.type != "cuda":
                    raise AssertionError("ae_train: the CLI did not train 2 steps on the card")
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            path = CK.checkpoint_path(os.path.join(tmp, "kitti", "ckpt"), 2)
            cfg, ae = load_yaml(LIDM_YAML), load_yaml(AE_YAML)["model"]["params"]
            fsp = cfg["model"]["params"]["first_stage_config"]["params"]
            fsp.update({k: ae[k] for k in ("ddconfig", "n_embed", "embed_dim", "use_mask")},
                       ckpt_path=path)
            model = instantiate_from_config(cfg["model"]).to("cuda").eval()
            CK.load_first_stage_params(fsp["ckpt_path"], model)
            ckpt = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
            same = all(torch.equal(v.cpu(), ckpt[k])
                       for k, v in model.first_stage_model.state_dict().items())
            (h, w), dd = load_yaml(AE_YAML)["data"]["params"]["dataset"]["size"], ae["ddconfig"]
            fh, fw = np.prod(dd["strides"], axis=0)
            with torch.inference_mode():
                img = model.decode_first_stage(
                    torch.randn((2, h // fh, w // fw, ae["embed_dim"]), device="cuda"))
            finite = bool(torch.isfinite(img).all())
            log(f"ae_train: the kitti run's checkpoint as the flagship LiDM's first stage: "
                f"weights equal to the file's {same}; decode {tuple(img.shape)} finite={finite}")
            if not same or not finite or tuple(img.shape) != (2, h, w, 1):
                raise AssertionError("ae_train: the run's checkpoint did not load as a first "
                                     "stage or decoded bad images")
            del model, img
            self.ae_run = os.path.join(tmp, "kitti")
        finally:
            shutil.rmtree(os.path.join(tmp, "nuscenes"), ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()

    def _timing_ae(self, gen, shapes=None, label="AE", steps=TRAIN_STEPS):
        """K3 forward and backward at an AE step's shapes in f32 (``shapes``,
        the kitti AE's by default), summed over ``steps`` timed steps:
        (forward totals, backward totals)."""
        import torch

        fwd, bwd = self._ae_shapes() if shapes is None else shapes
        tots = []
        for counts, fn, what in ((fwd, self._time_k3, "forward"),
                                 (bwd, self._time_k3_bwd, "backward")):
            log(f"  K3 {what} at the {label} training step's shapes (f32):")
            tot = collections.Counter()
            for (b, c, hh, ww, groups, act, eps), count in sorted(counts.items()):
                t = fn(gen, (b, c, hh, ww, groups, act), f"eps={eps:g} x{count}/step",
                       dtype=torch.float32, eps=eps)
                for k, v in t.items():
                    tot[k] += count * v * steps
            log(f"  K3 {what} over the {label}'s {steps} timed steps ({sum(counts.values())} "
                f"calls a step, f32): kernel {tot['ms']:.3f} ms (events {tot['events_ms']:.3f}) | "
                f"plain {tot['plain_ms']:.3f} | library {tot['library_ms']:.3f} "
                f"({tot['ms'] / tot['library_ms']:.3f}x) | bound {tot['bound_ms']:.3f} (kernel "
                f"at {100 * tot['bound_ms'] / tot['ms']:.1f}% of it)")
            tots.append(tot)
            torch.cuda.empty_cache()
        return tots

    # ------------------------------------------- patched (split_ks) serving
    def _split_shapes(self):
        """K1's and K3's calls of one patched DPM-20 request at SPLIT_BATCH,
        by shape: a crop is a training-size latent, so the U-Net runs the
        main request's shapes at batch SPLIT_BATCH, once a crop, and the
        decoder the main request's (all four crops of the batch in one
        call, batch 16). The split phase holds the launches to this."""
        if self.split_shapes is None:
            main = self._main_shapes()
            k1, k3 = collections.Counter(), collections.Counter()
            for (b, h, s_, d), n in main["flash_attention"].items():
                k1[(SPLIT_BATCH, h, s_, d)] += n * SPLIT_CROPS
            for key in main["group_norm"]:
                if self.gn_where[key, "unet"]:
                    k3[(SPLIT_BATCH, *key[1:])] += self.gn_where[key, "unet"] * SPLIT_CROPS
                if self.gn_where[key, "decoder"]:
                    k3[key] += self.gn_where[key, "decoder"]
            self.split_shapes = {"flash_attention": k1, "group_norm": k3}
        return self.split_shapes

    def _kernels_split(self):
        """K1 and K3 at the patched request's U-Net shapes (batch 4 a crop),
        f32 and bf16, against their plain versions; its decoder's shapes are
        the main request's, checked above."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from torch_port_helpers import attn_inputs

        shapes = self._split_shapes()
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(12)
        log(f"K1 and K3 at the patched request's shapes (64x2048, crops of 16x128 latents, "
            f"batch {SPLIT_BATCH}):")
        for dtype, t1, t3 in ((torch.float32, (2e-5, 1e-4), (1e-4, 1e-5)),
                              (torch.bfloat16, (1e-2, 2e-2), (2e-2, 1e-2))):
            for (b, h, s_, d) in sorted(shapes["flash_attention"]):
                q, k, v, kb = attn_inputs(gen, b, h, s_, d, dtype, False, False)
                got, want = A.flash_attention(q, k, v, kb), A._attend_ref(q, k, v, kb)
                self._check("flash_attention", got, want, *t1,
                            f"{(b, h, s_, d)} {str(dtype)[6:]} (split)", record=False)
                self.kernel_err["split_flash_attention"] = max(
                    self.kernel_err.get("split_flash_attention", 0.0), max_err(got, want)[0])
            for (b, c, hh, ww, groups, act) in sorted(k for k in shapes["group_norm"]
                                                      if k[0] == SPLIT_BATCH):
                x = (torch.randn((b, c, hh, ww), generator=gen, device=dev) * 2 + 0.3).to(dtype)
                gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
                beta = 0.1 * torch.randn(c, generator=gen, device=dev)
                got = G.group_norm(x, gamma, beta, groups, 1e-6, act)
                want = G._ref(x, gamma, beta, groups, 1e-6, act)
                self._check("group_norm", got, want, *t3,
                            f"{(b, c, hh, ww)} G={groups} act={act} {str(dtype)[6:]} (split), "
                            f"path: {path_name(G.kernel_path(dtype, c, hh * ww, groups))}",
                            record=False)
                self.kernel_err["split_group_norm"] = max(
                    self.kernel_err.get("split_group_norm", 0.0), max_err(got, want)[0])
            del q, k, v, x
        torch.cuda.empty_cache()

    def split_slice(self):
        """The tiny flagship served patched at JAX's test setting (split_ks
        (4, 16), split_stride (4, 8): a 4x32 latent in four crops, the last
        wrapping) from the same seeded weights on the card (kernels) and the
        CPU (plain versions), f32 with TF32 off: apply_model and the patched
        encode within SPLIT_SLICE_TOL of the largest magnitude (the two
        devices sum in other orders), the patched decode's ray-drop mask on
        99.9% of the pixels and its kept pixels within the same tolerance;
        K1's and K3's launches on the card against the structure."""
        import torch
        from lidar_layout_tpu_torch.flagship import flagship
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize

        model_gpu, image_shape = flagship(tiny=True, device="cuda", split=True)
        seed_weights(model_gpu, 0)
        model_cpu, _ = flagship(tiny=True, device="cpu", split=True)
        model_cpu.load_state_dict({k: v.cpu() for k, v in model_gpu.state_dict().items()})
        gen = torch.Generator().manual_seed(3)
        z = torch.randn((2, *model_gpu.cfg.latent_shape), generator=gen)
        t = torch.tensor([5, 60])
        img = torch.rand((2, *image_shape), generator=gen) * 2 - 1
        patches = len(range(0, model_gpu.cfg.latent_shape[1], model_gpu.cfg.split_stride[1]))
        count = {m: sum(isinstance(x, cls) for x in m.modules())
                 for m, cls in ((model_gpu.unet, Normalize),
                                (model_gpu.first_stage_model.encoder, Normalize),
                                (model_gpu.first_stage_model.decoder, Normalize))}
        attn = sum(isinstance(x, SelfAttentionBlock) for x in model_gpu.unet.modules())
        structure = {**{k: 0 for k in counters()},
                     "flash_attention": patches * attn,
                     "group_norm": patches * count[model_gpu.unet]
                     + count[model_gpu.first_stage_model.encoder]
                     + count[model_gpu.first_stage_model.decoder]}
        out = {}
        for dev, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            reset_counts()
            with torch.inference_mode():
                out[dev] = [r.float().cpu() for r in (
                    model.apply_model(z.to(dev), t.to(dev)),
                    model.encode_first_stage(img.to(dev)),
                    model.decode_first_stage(z.to(dev)))]
            if dev == "cuda":
                got = read_counts()
                log(f"split_slice on the card: launches {got}, structure {structure} "
                    f"({patches} crops of the U-Net, one encode and one decode of all crops)")
                if got != structure:
                    raise AssertionError("split_slice: launches differ from the structure")
        (ag, eg, dg), (ac, ec, dc) = out["cuda"], out["cpu"]
        errs = {"apply_model": max_err(ag, ac), "encode": max_err(eg, ec)}
        kept_g, kept_c = dg != -1.0, dc != -1.0
        agree = float((kept_g == kept_c).float().mean())
        both = kept_g & kept_c
        dec_err = float((dg - dc).abs()[both].max())
        log("split_slice, card vs CPU (f32, TF32 off): " + ", ".join(
            f"{k} max_abs_err {e:.3e} (|ref|max {m:.3e})" for k, (e, m) in errs.items())
            + f", decode ray-drop agreement {agree:.6f}, kept-pixel max_abs_err {dec_err:.3e}; "
            f"image {tuple(dg.shape)}")
        ok = all(e <= SPLIT_SLICE_TOL * max(1.0, m) for e, m in errs.values())
        ok = ok and agree >= 0.999 and dec_err <= SPLIT_SLICE_TOL * max(
            1.0, float(dc.abs().max()))
        if not ok or not all(bool(torch.isfinite(r).all()) for r in out["cuda"]):
            raise AssertionError("split_slice: the card's patched model disagrees with the CPU")
        del model_gpu, model_cpu
        torch.cuda.empty_cache()

    def split(self):
        """The flagship served patched at 64x2048 through GenerationPipeline:
        full width, seeded weights, bf16, DPM-20, generate(SPLIT_N) at batch
        SPLIT_BATCH after a warm-up request. Samples/s, the phase split
        (sample, decode, reproject; the U-Net's share of sample from a third
        request whose evals are synchronised), peak memory, and K1's and K3's
        launches a request against patches x evals x blocks (and one decode
        of all crops a batch)."""
        import dataclasses

        import torch
        from lidar_layout_tpu_torch.flagship import flagship
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline

        model, image_shape = flagship(dtype=torch.bfloat16, split=True)
        seed_weights(model, 0)
        card = card_line()
        geom = dataclasses.replace(KITTI_GEOMETRY, size=image_shape[:2])
        pipe = GenerationPipeline(model, geom, sampler="dpm", steps=20)
        lh, lw, _ = model.cfg.latent_shape
        patches = len(range(0, lw, model.cfg.split_stride[1]))
        assert patches == SPLIT_CROPS
        evals = unet_evals(model, 20)
        batches = SPLIT_N // SPLIT_BATCH
        attn = sum(isinstance(m, SelfAttentionBlock) for m in model.unet.modules())
        unet_norms = sum(isinstance(m, Normalize) for m in model.unet.modules())
        dec_norms = sum(isinstance(m, Normalize)
                        for m in model.first_stage_model.decoder.modules())
        want = {"flash_attention": batches * evals * patches * attn,
                "group_norm": batches * (evals * patches * unet_norms + dec_norms)}
        pipe.generate(SPLIT_BATCH, seed=99, batch=SPLIT_BATCH)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = pipe.generate(SPLIT_N, seed=0, batch=SPLIT_BATCH)
        got = read_counts()
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        # the U-Net's share of the sample phase: every eval synchronised
        unet_s = [0.0]
        real = model.apply_model

        def timed_apply(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            unet_s[0] += time.perf_counter() - t0
            return out
        model.apply_model = timed_apply
        try:
            res_t = pipe.generate(SPLIT_N, seed=1, batch=SPLIT_BATCH)
        finally:
            del model.apply_model
        imgs = res.images
        log(f"split DPM-20 at {image_shape[0]}x{image_shape[1]} (latent {lh}x{lw} in "
            f"{patches} crops of {model.cfg.split_ks} at a stride of {model.cfg.split_stride}; "
            f"generate({SPLIT_N}) at batch {SPLIT_BATCH}, bf16): images {imgs.shape} finite="
            f"{bool(np.isfinite(imgs).all())} clouds={len(res.clouds)} (median "
            f"{int(np.median([len(c) for c in res.clouds]))} points); "
            f"{res.samples_per_sec:.4f} samples/s; phases "
            + ", ".join(f"{k} {v:.4f} s" for k, v in res.phase_seconds.items())
            + f"; U-Net {unet_s[0]:.4f} s of a synchronised request's sample "
            f"{res_t.phase_seconds['sample']:.4f} s ({evals} evals x {patches} crops x "
            f"{batches} batches); peak memory {mem:.2f} GiB; launches {got} expected "
            f"{want} ({attn} attention blocks and {unet_norms} norms a U-Net eval, "
            f"{dec_norms} a decode); card {card}")
        if imgs.shape != (SPLIT_N, *image_shape) or not np.isfinite(imgs).all() \
                or len(res.clouds) != SPLIT_N:
            raise AssertionError("split: bad output")
        if {k: got[k] for k in want} != want or sum(got.values()) != sum(want.values()):
            raise AssertionError(f"split: launch counts {got} != {want}")
        self.split_launches = got
        del model, pipe
        gc.collect()
        torch.cuda.empty_cache()

    def _timing_split(self, gen):
        """K1 and K3 in bf16 at the patched request's shapes, summed over the
        split phase's DPM-20 run."""
        runs = SPLIT_N // SPLIT_BATCH
        shapes = self._split_shapes()
        log(f"  K1 at the patched request's shapes (per request of {SPLIT_BATCH}):")
        k1 = self._time_k1(gen, shapes["flash_attention"], runs, label=" (split)")
        log(f"  K3 at the patched request's shapes (per request of {SPLIT_BATCH}):")
        k3 = collections.Counter()
        for key, count in sorted(shapes["group_norm"].items()):
            for name, val in self._time_k3(gen, key, f"x{count}/request (split)").items():
                k3[name] += count * val * runs
        for name, tot in (("flash_attention", k1), ("group_norm", k3)):
            log(f"  {name} over the patched run (generate({SPLIT_N}), batch {SPLIT_BATCH}): "
                f"kernel {tot['ms']:.3f} ms | plain {tot['plain_ms']:.3f} | library "
                f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | bound "
                f"{tot['bound_ms']:.3f} (kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}% "
                f"of it)")
            self.run_totals.setdefault(name, {})["split"] = tot

    def _timing_sp(self, gen, totals):
        """The cross-length K1 (beside SDPA on the same cross-length inputs,
        in turns) and the split K3's two kernels (no one library call
        computes either alone) in f32 at the sp phase's shapes, each summed
        over a rank's sharded encode and apply_model: kernel, plain version,
        bound (K1: operations at the f32 peak; K3: x read once, y or the
        statistics written once)."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G

        if self.sp_shapes is None:
            log("  the sp shapes come from the sp phase, which did not run")
            return
        dev = torch.device("cuda")
        sp = self.sp_size
        tot = {k: collections.Counter() for k in sp_counters()}
        log(f"  the sp kernels in f32 at the sp phase's shapes ({sp} shards; per rank, one "
            f"sharded encode and apply_model at batch {SP_BATCH}):")
        for (name, key), count in sorted(self.sp_shapes.items()):
            if name == "flash_attention_xl":
                b, h, sq, skv, d = key
                q = torch.randn((b, h, sq, d), generator=gen, device=dev)
                k, v = (torch.randn((b, h, skv, d), generator=gen, device=dev) for _ in range(2))
                cost = A.attention_cost(b, h, sq, d, 4, s_kv=skv)
                kms, lms, _, _ = paired_ms(lambda: A._launch_xl(q, k, v),
                                           lambda: F.scaled_dot_product_attention(q, k, v), 10)
                bound = {"ops": cost["flops"] / PEAK_F32 * 1e3,
                         "bytes": cost["bytes"] / HBM_BYTES_PER_S * 1e3}
                t = {"ms": kms, "plain_ms": device_ms(lambda: A._attend_ref(q, k, v), 5),
                     "library_ms": lms}
                parts = {name: t}
            else:
                b, c, hh, ww, groups, act = key
                n = b * c * hh * ww
                call, copies = cold_ring(lambda: (torch.randn((b, c, hh, ww), generator=gen,
                                                              device=dev),), 4 * n)
                gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
                st = G.group_norm_stats(call(lambda x: x), groups)
                cnt = c // groups * hh * ww * sp
                bound = {"stats": {"ops": 3 * n / PEAK_F32 * 1e3,
                                   "bytes": (4 * n + 8 * b * groups) / HBM_BYTES_PER_S * 1e3},
                         "apply": {"ops": 10 * n / PEAK_F32 * 1e3,
                                   "bytes": (8 * n + 8 * c + 8 * b * groups)
                                   / HBM_BYTES_PER_S * 1e3}}
                parts = {
                    "group_norm_stats": {
                        "ms": device_ms(lambda: call(lambda x: G.group_norm_stats(x, groups)), 20),
                        "plain_ms": device_ms(lambda: call(lambda x: G._stats_ref(x, groups)), 5),
                        "library_ms": 0.0},
                    "group_norm_apply": {
                        "ms": device_ms(lambda: call(lambda x: G.group_norm_apply(
                            x, st, gamma, beta, groups, cnt, 1e-6, act)), 20),
                        "plain_ms": device_ms(lambda: call(lambda x: G._apply_ref(
                            x, st, gamma, beta, groups, cnt, 1e-6, act)), 5),
                        "library_ms": 0.0}}
                bound = {"group_norm_stats": bound["stats"], "group_norm_apply": bound["apply"]}
            for kname, t in parts.items():
                bd = bound if name == "flash_attention_xl" else bound[kname]
                t["bound_ms"] = max(bd.values())
                bound_gate(f"{kname} {key}", t["bound_ms"], t["ms"])
                lib = (f" | sdpa {t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.3f}x)"
                       if kname == "flash_attention_xl" else "")
                log(f"    {kname} {key} x{count}: kernel {t['ms']:.4f} | plain "
                    f"{t['plain_ms']:.4f}{lib} | bound {t['bound_ms']:.4f} "
                    f"({'operations' if bd['ops'] >= bd['bytes'] else 'bytes'}; kernel at "
                    f"{100 * t['bound_ms'] / t['ms']:.1f}% of it)")
                for k_, val in t.items():
                    tot[kname][k_] += count * val
                tot[kname]["bound_ops_ms"] += count * bd["ops"]
                tot[kname]["bound_bytes_ms"] += count * bd["bytes"]
        for kname, t in tot.items():
            t["events_ms"] = t["ms"]
            if kname != "flash_attention_xl":
                t["library_ms"] = None   # no one PyTorch call computes a half of K3
            totals[kname] = t
            lib = (f" | sdpa {t['library_ms']:.3f} ({t['ms'] / t['library_ms']:.3f}x)"
                   if t["library_ms"] else " | library: none")
            log(f"  {kname} over a rank's sharded encode and apply_model: kernel "
                f"{t['ms']:.3f} ms | plain {t['plain_ms']:.3f}{lib} | bound {t['bound_ms']:.3f} "
                f"(kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of it)")

    # ------------------------------------------------- the AE in bf16
    @staticmethod
    def _perceptual(geom, device):
        """The perceptual loss on a RangeNet-21 drawn from seed 0 (the same
        weights on every device)."""
        from lidar_layout_tpu_torch.losses.perceptual import make_perceptual_fn

        return make_perceptual_fn(geom, rng_seed=0, device=device)

    def ae_bf16_slice(self):
        """One VQ-GAN step of the kitti AE with the perceptual term and linear
        attention (AE_BF16_SLICE overrides, 32x256 images at batch 4; seeded
        weights) at step 0: in f32 on the card against the CPU (every log
        within AE_PERC_LOG_TOL relative, d_weight within AE_PERC_DWEIGHT_TOL,
        both models' gradients within AE_PERC_GRAD_TOL relative L2), then in
        bf16 on the card against the card's f32 step (the well-conditioned
        logs within AE_BF16_TOL, AE_BF16_ILL within AE_BF16_ILL_TOL, the
        discriminator's gradients within AE_BF16_DISC_GRAD_TOL); then one
        more f32 and bf16 pair on the card with AE_BF16_SMOOTH, the
        generator's gradients within AE_BF16_GEN_GRAD_TOL (with every term
        on they are swamped by rounding at random weights, and logged); K3's
        launches on the card against the structure and hooks."""
        import torch
        from lidar_layout_tpu_torch.nn.blocks import LinearAttnBlock
        from lidar_layout_tpu_torch.train import ae_trainer as AT
        from torch_port_helpers import count_group_norms

        batch = self._ae_batches(1, seed=4, device="cpu", overrides=AE_BF16_SLICE)[0]
        runs = {}
        smooth = AE_BF16_SLICE + AE_BF16_SMOOTH
        for run, dev, amp, over in (("cuda", "cuda", None, AE_BF16_SLICE),
                                    ("cpu", "cpu", None, AE_BF16_SLICE),
                                    ("cuda_bf16", "cuda", torch.bfloat16, AE_BF16_SLICE),
                                    ("cuda_smooth", "cuda", None, smooth),
                                    ("cuda_smooth_bf16", "cuda", torch.bfloat16, smooth)):
            model, disc, loss_cfg, geo, state = self._ae_setup(dev, overrides=over)
            assert isinstance(model.encoder.mid.attn_1, LinearAttnBlock)
            step = AT.make_ae_train_step(model, disc, loss_cfg, geo,
                                         perceptual_fn=self._perceptual(geo.geom, dev),
                                         autocast_dtype=amp)
            grads = {}
            for part, opt, module in (("generator", state.opt_g, model),
                                      ("discriminator", state.opt_d, disc)):
                def spy(gs, real=opt.step, part=part):
                    grads[part] = torch.cat([g_.detach().float().flatten() for g_ in gs]).cpu()
                    return real(gs)
                opt.step = spy
            structure = self._ae_structure(model, disc)[0]
            reset_counts()
            t0 = time.perf_counter()
            with count_group_norms(model, disc) as (fwd, bwd):
                state, logs = step(state, {k: v.to(dev) for k, v in batch.items()},
                                   torch.Generator(device=dev))
            launches = read_counts()
            runs[run] = {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads}
            log(f"ae_bf16_slice {run}: {time.perf_counter() - t0:.1f} s; " + ", ".join(
                f"{k} {v:.6g}" for k, v in sorted(runs[run]["logs"].items())))
            if dev == "cuda":
                hooked = {**{k: 0 for k in counters()}, "group_norm": sum(fwd.values()),
                          "group_norm_bwd": sum(bwd.values())}
                log(f"ae_bf16_slice {run}: K3 launches {launches}, hooks {hooked}, structure "
                    f"{structure}")
                if not launches == hooked == structure:
                    raise AssertionError(f"ae_bf16_slice {run}: K3 launches differ from the "
                                         f"structure or the hooks")
            del model, disc, state, step
            gc.collect()
            torch.cuda.empty_cache()

        def rel(a, b):
            return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        g, c, h = runs["cuda"], runs["cpu"], runs["cuda_bf16"]
        bad = []
        for part, tol, (low, exact) in (
                ("discriminator", AE_BF16_DISC_GRAD_TOL, ("cuda_bf16", "cuda")),
                ("generator", AE_BF16_GEN_GRAD_TOL, ("cuda_smooth_bf16", "cuda_smooth"))):
            r = rel(runs[low]["grads"][part], runs[exact]["grads"][part])
            log(f"ae_bf16_slice {low} vs {exact}: {part} gradients relative L2 {r:.3e} "
                f"(gate {tol:g})")
            if not r <= tol:
                bad.append(f"bf16 {part} gradients {r:.3e} from f32 ({low})")
        for k, want in c["logs"].items():
            tol = AE_PERC_DWEIGHT_TOL if k == "d_weight" else AE_PERC_LOG_TOL
            if abs(g["logs"][k] - want) > tol * abs(want) + 1e-7:
                bad.append(f"f32 {k} {g['logs'][k]:.6g} vs CPU {want:.6g}")
        for part in ("generator", "discriminator"):
            r = rel(g["grads"][part], c["grads"][part])
            log(f"ae_bf16_slice f32 card vs CPU: {part} gradients relative L2 {r:.3e} "
                f"(gate {AE_PERC_GRAD_TOL:g}); bf16 card vs f32 card "
                f"{rel(h['grads'][part], g['grads'][part]):.3e} (every term on)")
            if not r <= AE_PERC_GRAD_TOL:
                bad.append(f"f32 {part} gradients {r:.3e}")
            if not bool(torch.isfinite(h["grads"][part]).all()):
                bad.append(f"bf16 {part} gradients not finite")
        for k, want in g["logs"].items():
            if k.startswith("seconds"):
                continue
            tol = AE_BF16_ILL_TOL if k in AE_BF16_ILL else AE_BF16_TOL
            err = abs(h["logs"][k] - want) / max(abs(want), 1e-7)
            log(f"  ae_bf16_slice bf16 vs f32 on the card: {k} {h['logs'][k]:.6g} vs "
                f"{want:.6g} ({err:.2e} relative; tolerance {tol:g})")
            if abs(h["logs"][k] - want) > tol * abs(want) + 1e-6:
                bad.append(f"bf16 {k} {h['logs'][k]:.6g} vs f32 {want:.6g}")
        if bad:
            raise AssertionError("ae_bf16_slice: " + "; ".join(bad))

    def ae_bf16(self):
        """The kitti AE trained as ``train_lidm --bf16`` trains it, with the
        perceptual term (AE_BF16_OVERRIDES; a RangeNet-21 drawn from the
        seed): the CLI's own builder (``_ae_training``: JAX-drawn
        discriminator, the perceptual net, bf16 autocast) over the seeded
        model, full width, batch 4, on one synthetic batch at the YAML's lr
        (AE_LR: over 20 steps at 1e-4 the loss only wobbled on the H100). Two
        warm-ups (the first under hooks), AE_BF16_STEPS timed steps:
        steps/s, peak memory, K3's launches a step against the structure
        and hooks, no plain GroupNorm, rec_loss falling over the timed
        steps; then three synchronised steps of the same step with the
        perceptual net timed apart: its share of a step."""
        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config
        from lidar_layout_tpu_torch.losses.geometric import GeoConverter
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from lidar_layout_tpu_torch.pipeline import geometry_from_config
        from lidar_layout_tpu_torch.train import ae_trainer as AT
        from lidar_layout_tpu_torch.train import train_lidm
        from torch_port_helpers import count_group_norms

        card = card_line()
        cfg = yaml_config(AE_YAML, AE_BF16_OVERRIDES)
        geom = geometry_from_config(cfg)
        model = seed_weights(instantiate_from_config(cfg["model"]), 0).cuda()
        state, step, _, _ = train_lidm._ae_training(model, cfg["model"], geom, AE_LR, 1, None,
                                                    amp=torch.bfloat16, seed=0)
        disc = state.disc
        batch = self._ae_batches(1)[0]
        gen = torch.Generator(device="cuda").manual_seed(0)
        structure, n_ae, n_disc = self._ae_structure(model, disc)
        reset_counts()
        with count_group_norms(model) as ae_shapes, count_group_norms(disc) as disc_shapes:
            state, logs = step(state, batch, gen)                  # warm-up 1, hooked
            torch.cuda.synchronize()
        first = read_counts()
        self.ae_bf16_shapes = (ae_shapes, disc_shapes)
        hooked = {**{k: 0 for k in counters()},
                  "group_norm": sum(ae_shapes[0].values()) + sum(disc_shapes[0].values()),
                  "group_norm_bwd": sum(ae_shapes[1].values()) + sum(disc_shapes[1].values())}
        state, logs = step(state, batch, gen)                      # warm-up 2
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        plain, real = collections.Counter(), (G._ref, G._group_norm_bwd_ref)

        def counting(n_, fn):
            def wrapped(*a, **k):
                plain[n_] += 1
                return fn(*a, **k)
            return wrapped
        G._ref, G._group_norm_bwd_ref = (counting("_ref", real[0]),
                                         counting("_group_norm_bwd_ref", real[1]))
        try:
            t0 = time.perf_counter()
            curve = []
            for _ in range(AE_BF16_STEPS):
                state, logs = step(state, batch, gen)
                curve.append(logs["rec_loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            G._ref, G._group_norm_bwd_ref = real
        got = read_counts()
        self.ae_bf16_launches = got
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        curve = [float(c_) for c_ in curve]
        per_step = {k: v / AE_BF16_STEPS for k, v in got.items()}
        # the perceptual net's share: the same step built with it timed apart
        loss_cfg = instantiate_from_config(cfg["model"]["params"]["lossconfig"])
        assert loss_cfg.perceptual_factor > 0
        net_fn = self._perceptual(geom, "cuda")
        spent = [0.0]

        def timed_fn(target, recon):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            out = net_fn(target, recon)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t_
            return out
        timed_step = AT.make_ae_train_step(
            model, disc, loss_cfg, GeoConverter(geom, curve_length=loss_cfg.curve_length),
            perceptual_fn=timed_fn, autocast_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = timed_step(state, batch, gen)
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
        first_half, last_half = np.mean(curve[:3]), np.mean(curve[-3:])
        log(f"ae_bf16 ({os.path.relpath(AE_YAML, HERE)} with {list(AE_BF16_OVERRIDES)}, batch "
            f"{AE_BATCH}, bf16 autocast, lr {AE_LR:g} on one batch, {AE_BF16_STEPS} timed "
            f"steps): {AE_BF16_STEPS / wall:.3f} steps/s, {AE_BF16_STEPS * AE_BATCH / wall:.2f} "
            f"samples/s; peak memory {mem:.2f} GiB; perceptual net (its forward and backward "
            f"calls, synchronised) {spent[0] / 3:.4f} s of a synchronised step's "
            f"{timed_wall / 3:.4f} s ({100 * spent[0] / timed_wall:.1f}%); launches per step "
            f"{per_step} (structure {structure}: {n_ae} autoencoder norms, {n_disc} "
            f"discriminator norms; hooks {hooked}; first step {first}); plain GroupNorm calls "
            f"{dict(plain)}; rec_loss over the timed steps {[round(c_, 5) for c_ in curve]} "
            f"(mean of the first 3 {first_half:.5f}, of the last 3 {last_half:.5f}); card {card}")
        if (per_step != {k: float(v) for k, v in structure.items()} or first != structure
                or hooked != structure):
            raise AssertionError(f"ae_bf16: launches per step {per_step} (first {first}, hooks "
                                 f"{hooked}) != structure {structure}")
        if sum(plain.values()) or not np.isfinite(curve).all() or not last_half < first_half:
            raise AssertionError(f"ae_bf16: plain GroupNorm ran {dict(plain)}, or rec_loss is "
                                 f"not finite or did not fall")
        del model, disc, state, step, timed_step
        gc.collect()
        torch.cuda.empty_cache()

    def _timing_ae_bf16(self, gen):
        """K3 forward and backward at the bf16 AE step's shapes, in the dtype
        each runs in (the autoencoder's in bf16, the discriminator's in
        f32), summed over the ae_bf16 phase's timed steps."""
        import torch

        if self.ae_bf16_shapes is None:
            raise AssertionError("the timing of the bf16 AE needs the ae_bf16 phase")
        ae, disc = self.ae_bf16_shapes
        tots = []
        for i, (fn, what) in enumerate(((self._time_k3, "forward"),
                                        (self._time_k3_bwd, "backward"))):
            tot = collections.Counter()
            for counts, dtype, who in ((ae[i], torch.bfloat16, "autoencoder"),
                                       (disc[i], torch.float32, "discriminator")):
                log(f"  K3 {what} at the bf16 AE step's {who} shapes ({str(dtype)[6:]}):")
                for (b, c, hh, ww, groups, act, eps), count in sorted(counts.items()):
                    t = fn(gen, (b, c, hh, ww, groups, act), f"eps={eps:g} x{count}/step",
                           dtype=dtype, eps=eps)
                    for k, v in t.items():
                        tot[k] += count * v * AE_BF16_STEPS
            log(f"  K3 {what} over the bf16 AE's {AE_BF16_STEPS} timed steps: kernel "
                f"{tot['ms']:.3f} ms | plain {tot['plain_ms']:.3f} | library "
                f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | bound "
                f"{tot['bound_ms']:.3f} (kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}% "
                f"of it)")
            tots.append(tot)
            torch.cuda.empty_cache()
        self.run_totals.setdefault("group_norm", {})["ae_bf16_train"] = tots[0]
        self.run_totals.setdefault("group_norm_bwd", {})["ae_bf16_train"] = tots[1]

    # ----------------------------------------------------------------- data
    def data(self):
        """The data layer on the card's host: DATA_SCANS KITTI-360 velodyne
        scans (synthetic scenes of 120,000 points with remission) written to
        a temporary root, read by RangeImageDataset through the native loader
        (built from native/lidar_io.cpp by g++) and through the Python
        reader: the same batches, and the native path taken, or the phase
        fails; then device_synthetic's scene_image_batch on the card: its
        valid-pixel fraction and depth percentiles."""
        import torch
        from lidar_layout_tpu_torch.data import device_synthetic as DS
        from lidar_layout_tpu_torch.data.datasets import RangeImageDataset
        from lidar_layout_tpu_torch.data.native_loader import build_native
        from lidar_layout_tpu_torch.data.synthetic import synthetic_scene
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY

        t0 = time.perf_counter()
        so = build_native()
        log(f"data: native loader {os.path.relpath(str(so), HERE)} ready in "
            f"{time.perf_counter() - t0:.1f} s")
        root = self.tmp_dir("kitti360_")
        scans = os.path.join(root, "data_3d_raw", "2013_05_28_drive_0000_sync",
                             "velodyne_points", "data")
        os.makedirs(scans)
        rng = np.random.default_rng(11)
        for i in range(DATA_SCANS):
            pts = synthetic_scene(rng)
            rem = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
            np.concatenate([pts, rem], 1).astype(np.float32).tofile(
                os.path.join(scans, f"{i:010d}.bin"))
        sets = {}
        for reader in ("native", "python"):
            ds = RangeImageDataset(root, batch_size=DATA_BATCH, seed=5, device="cuda")
            it = ds.batches(use_native=reader == "native")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sets[reader] = [next(it) for _ in range(DATA_SCANS // DATA_BATCH * 2)]
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / len(sets[reader])
            log(f"data: {len(sets[reader])} batches of {DATA_BATCH} scans through the "
                f"{ds.reader} reader (two passes, reshuffled): {sec:.4f} s a batch "
                f"(read and projected on the card)")
            if ds.reader != reader:
                raise AssertionError(f"data: asked for the {reader} reader, {ds.reader} ran")
        same = all(torch.equal(a[k], b[k]) for a, b in zip(sets["native"], sets["python"])
                   for k in b)
        log(f"data: native batches equal the Python reader's: {same}")
        if not same:
            raise AssertionError("data: the native loader's batches differ from the Python "
                                 "reader's")
        gen = torch.Generator(device="cuda").manual_seed(0)
        DS.scene_image_batch(gen, DATA_BATCH)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, mask = DS.scene_image_batch(gen, DATA_BATCH)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        valid = mask > 0
        depth = (torch.exp2((img * 0.5 + 0.5) * KITTI_GEOMETRY.depth_scale) - 1.0)[valid]
        pct = torch.quantile(depth.float()[:2 ** 24], torch.tensor([0.1, 0.5, 0.9],
                                                                    device="cuda"))
        log(f"data: device_synthetic.scene_image_batch({DATA_BATCH}) on the card: "
            f"{tuple(img.shape)} in {sec:.4f} s; valid fraction "
            f"{float(valid.float().mean()):.4f}; depth percentiles 10/50/90 "
            f"{[round(float(p), 3) for p in pct]} m; image range "
            f"[{float(img.min()):.3f}, {float(img.max()):.3f}]")
        if img.shape != (DATA_BATCH, *KITTI_GEOMETRY.size) or not bool(torch.isfinite(img).all()) \
                or not 0.1 < float(valid.float().mean()) < 0.9:
            raise AssertionError("data: device_synthetic's batch is off")

    # ------------------------------------------------------ the coarse stage
    @staticmethod
    def _coarse_ldm(device="cuda", dtype=None):
        """The coarse LiDM of its YAML at full width (the U-Net 128 wide, the
        first stage with its ray-drop head), seeded weights."""
        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml

        model = instantiate_from_config(load_yaml(COARSE_LDM_YAML)["model"],
                                        dtype=dtype or torch.float32)
        return seed_weights(model, 0).to(device)

    @staticmethod
    def _coarse_batches(n, batch, seed=6, device="cuda"):
        """``n`` synthetic nusc_range batches at the coarse 8x256 geometry
        (the YAML's dataset block)."""
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.data.synthetic import synthetic_range_batch
        from lidar_layout_tpu_torch.pipeline import geometry_from_config

        rng = np.random.default_rng(seed)
        geom = geometry_from_config(load_yaml(COARSE_LDM_YAML))
        return [synthetic_range_batch(rng, AE_BATCH, geom, device=device) for _ in range(n)]

    def _coarse_shapes(self):
        """The coarse paths' kernel calls by shape, from module hooks: one
        DPM-20 request at batch 16 in bf16 (K1, K3), one LiDM training step
        at batch 16 under bf16 autocast (K1, K2, K3 forward and backward),
        one AE training step at batch 4 in f32 (K3 forward and backward)."""
        if self.coarse_shapes is None:
            import torch
            from lidar_layout_tpu_torch.train import diffusion_trainer as DT
            from torch_port_helpers import count_group_norms

            model = self._coarse_ldm(dtype=torch.bfloat16).eval()
            request, where = self._request_shapes(model)
            del model
            model = self._coarse_ldm()
            params = DT.trainable_params(model)
            state = DT.create_train_state(model, DT.make_optimizer(params, COARSE_LR), params)
            train, hooks = self._train_hooks(model)
            DT.make_train_step(model, autocast_dtype=torch.bfloat16)(
                state, self._coarse_batches(1, TRAIN_BATCH)[0],
                torch.Generator(device="cuda").manual_seed(0))
            for hk in hooks:
                hk.remove()
            del model, state, params
            model, disc, loss_cfg, geo, state = self._ae_setup(yaml_path=COARSE_AE_YAML)
            with count_group_norms(model, disc) as ae:
                ae_step(model, disc, loss_cfg, geo)(
                    state, self._ae_batches(1, yaml_path=COARSE_AE_YAML)[0],
                    torch.Generator(device="cuda").manual_seed(0))
            self.coarse_shapes = {"request": request, "where": where, "train": train, "ae": ae}
            del model, disc, state
            gc.collect()
            torch.cuda.empty_cache()
            for name, cnt in request.items():
                log(f"coarse {name} launches per DPM-20 request (batch {BATCH}): "
                    f"{sum(cnt.values())} over shapes {dict(sorted(cnt.items()))}")
        return self.coarse_shapes

    def _kernels_coarse(self):
        """K1 and K2 at the coarse LiDM's attention shapes (S = 128 at 4x32,
        S = 32 at 2x16, S = 8 in the middle block), f32 and bf16, each against
        its plain version and bit for bit over two launches; K3 forward and
        backward at every group shape of the coarse paths (the U-Net and the
        decoder in bf16, the AE step in f32), against the plain versions,
        the backward bit for bit over two launches, with the path each
        takes."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from torch_port_helpers import attn_inputs

        shapes = self._coarse_shapes()
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(12)
        attn = sorted(set(shapes["request"]["flash_attention"])
                      | set(shapes["train"]["flash_attention_bwd"]))
        tol1 = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
        tol2 = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
        log(f"K1 and K2 at the coarse LiDM's attention shapes {attn}:")
        for dtype in (torch.float32, torch.bfloat16):
            for (b, h, s, d) in attn:
                q, k, v, _ = attn_inputs(gen, b, h, s, d, dtype, False, False)
                what = f"{(b, h, s, d)} {str(dtype)[6:]} (coarse)"
                self._check_coarse("flash_attention", A.flash_attention(q, k, v),
                                   A._attend_ref(q, k, v), *tol1[dtype], what)
                o, lse = A._launch(q, k, v, None, with_lse=True)
                o2, lse2 = A._launch(q, k, v, None, with_lse=True)
                do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
                got = A.flash_attention_bwd(q, k, v, o, do, lse)
                want = A._attend_bwd_ref(q, k, v, o, do, lse)
                for part, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                    self._check_coarse("flash_attention_bwd", g_, w_, *tol2[dtype],
                                       f"{part} {what}")
                again = A.flash_attention_bwd(q, k, v, o, do, lse)
                torch.cuda.synchronize()
                same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                        and all(torch.equal(a_, g_) for a_, g_ in zip(again, got)))
                log(f"  {what}: two launches of K1 and of K2 bit for bit equal: {same}")
                if not same:
                    raise AssertionError(f"K1 or K2 is not deterministic at {what}")
        gn = {(*key[:5], torch.bfloat16, 1e-6) for key in shapes["request"]["group_norm"]}
        gn |= {(*key[:5], torch.bfloat16, 1e-6) for key in shapes["train"]["group_norm_bwd"]}
        gn |= {(*key[:5], torch.float32, key[6]) for key in set(shapes["ae"][0])
               | set(shapes["ae"][1])}
        log(f"K3 forward and backward at every group shape of the coarse paths "
            f"({len(gn)} shapes):")
        for (b, c, hh, ww, groups, dtype, eps) in sorted(gn, key=str):
            x = (torch.randn((b, c, hh, ww), generator=gen, device=dev) * 2 + 0.3).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
            beta = 0.1 * torch.randn(c, generator=gen, device=dev)
            dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            f32 = dtype == torch.float32
            what = (f"{(b, c, hh, ww)} G={groups} {str(dtype)[6:]} eps={eps:g} (paths: forward "
                    f"{path_name(G.kernel_path(dtype, c, hh * ww, groups))}, backward "
                    f"{path_name(G.kernel_path(dtype, c, hh * ww, groups, True))})")
            for act in (False, True):
                self._check_coarse("group_norm", G.group_norm(x, gamma, beta, groups, eps, act),
                                   G._ref(x, gamma, beta, groups, eps, act),
                                   *((1e-4, 1e-5) if f32 else (2e-2, 1e-2)),
                                   f"{what} act={act}")
                got = G.group_norm_bwd(x, gamma, beta, dy, groups, eps, act)
                want = G._group_norm_bwd_ref(x, gamma, beta, dy, groups, eps, act)
                for part, g_, w_, t_ in zip(("dx", "dgamma", "dbeta"), got, want,
                                            ((1e-4, 1e-4) if f32 else (2e-2, 1e-2),
                                             (1e-3, 1e-4), (1e-3, 1e-4))):
                    self._check_coarse("group_norm_bwd", g_, w_, *t_, f"{part} {what} act={act}")
                again = G.group_norm_bwd(x, gamma, beta, dy, groups, eps, act)
                torch.cuda.synchronize()
                if not all(torch.equal(a_, g_) for a_, g_ in zip(again, got)):
                    raise AssertionError(f"K3's backward is not deterministic at {what}")
            del x, dy, got, want, again
        torch.cuda.empty_cache()

    def _check_coarse(self, name, got, want, atol, rtol, what):
        self._check(name, got, want, atol, rtol, what, record=False)
        key = f"coarse_{name}"
        self.kernel_err[key] = max(self.kernel_err.get(key, 0.0), max_err(got, want)[0])

    def coarse_slice(self):
        """Card against CPU at full width, f32, TF32 off: the coarse AE's
        VQ-GAN step at batch 4 from the same weights (ae_train_slice's gates
        at steps 0 and 2, K3's launches against the structure and hooks);
        the coarse LiDM's apply_model and a DDIM-3 + decode at batch 4 (the
        latent within 1e-3 of its largest value, the ray-drop mask in 99.9%
        agreement, kept pixels within 1e-3), and one training step at batch 4
        (train_slice's gates: loss, U-Net gradients, parameters and EMA)."""
        import torch
        from lidar_layout_tpu_torch.models.samplers import ddim_sample

        self._ae_slice("coarse_slice AE", COARSE_AE_YAML, tf32_control=False)
        models = {dev: self._coarse_ldm(dev).eval() for dev in ("cuda", "cpu")}
        gen = torch.Generator().manual_seed(3)
        lh, lw, lc = models["cpu"].cfg.latent_shape
        x = torch.randn((4, lh, lw, lc), generator=gen)
        t = torch.tensor([10, 250, 600, 990])
        out = {}
        for dev, model in models.items():
            t0 = time.perf_counter()
            with torch.inference_mode():
                eps = model.apply_model(x.to(dev), t.to(dev))
                z = ddim_sample(model, x.shape, steps=3, x_T=x, device=dev)
                img = model.decode_first_stage(z)
            out[dev] = (eps.cpu(), z.cpu(), img.cpu())
            log(f"coarse_slice LiDM on {dev}: {time.perf_counter() - t0:.1f} s")
        with torch.inference_mode():   # the card's latent decoded on the CPU too
            img_same = models["cpu"].decode_first_stage(out["cuda"][1])
        (eps_g, z_g, img_g), (eps_c, z_c, _) = out["cuda"], out["cpu"]
        eps_rel = float((eps_g - eps_c).norm() / eps_c.norm())
        zerr, zscale = max_err(z_g, z_c)
        drop_g, drop_c = img_g == -1.0, img_same == -1.0
        agree = float((drop_g == drop_c).float().mean())
        both = ~drop_g & ~drop_c
        kept = float((img_g - img_same).abs()[both].max())
        log(f"coarse_slice LiDM (batch 4, f32): apply_model relative L2 error {eps_rel:.3e} "
            f"(tol 1e-4); DDIM-3 latent max_abs_err {zerr:.3e} (|z|max {zscale:.3e}); decode "
            f"{tuple(img_g.shape)}: ray-drop share {float(drop_g.float().mean()):.4f}, mask "
            f"agreement {agree:.6f}, kept-pixel max_abs_err {kept:.3e}")
        if not (eps_rel <= 1e-4 and zerr <= 1e-3 * max(zscale, 1.0) and agree >= 0.999
                and kept <= 1e-3 and tuple(img_g.shape) == (4, 8, 256, 1)
                and bool(torch.isfinite(img_g).all()) and 0 < float(drop_g.float().mean()) < 1):
            raise AssertionError("coarse_slice: the card's LiDM disagrees with the CPU's")
        del models
        gc.collect()
        torch.cuda.empty_cache()
        batch = self._coarse_batches(1, 4, seed=4, device="cpu")[0]
        self._slice_step("coarse_slice LiDM step", lambda dev: self._coarse_ldm(dev), batch,
                         [("U-Net", lambda k: True)], lr=COARSE_LR)

    def coarse(self):
        """The coarse stage at full width on the card: serving, LiDM
        training, AE training, and the CLI (_coarse_serve, _coarse_train,
        _ae_train_run, _coarse_cli)."""
        self._coarse_serve()
        self._coarse_train()
        self.coarse_ae_train_launches, shapes = self._ae_train_run(
            "coarse AE train", COARSE_AE_YAML, accumulate=2, overfit=False)
        self.coarse_shapes = {**self._coarse_shapes(), "ae": shapes}
        self._coarse_cli()

    def _coarse_serve(self):
        """GenerationPipeline.from_config of the coarse LiDM YAML in bf16,
        seeded weights: generate(32) at batch 16 with DPM-20 and DDIM-50;
        the geometry from the YAML's dataset block, samples/s and the split
        into sample, decode and reproject, peak memory, finite (32, 8, 256, 1)
        images with ray-drop pixels, K1 and K3 launches against the
        structure and module hooks (no K2, no K4)."""
        import torch
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline

        card = card_line()
        pipe = GenerationPipeline.from_config(COARSE_LDM_YAML, bf16=True, device="cuda")
        model = seed_weights(pipe.model, 0)
        g = pipe.geom
        log(f"coarse: from_config geometry size {g.size}, fov {g.fov}, depth_range "
            f"{g.depth_range}; first stage use_mask={model.first_stage_model.use_mask}, out_ch "
            f"{model.first_stage_model.cfg.out_ch}; latent {model.cfg.latent_shape}")
        if (tuple(g.size), tuple(g.fov), tuple(g.depth_range)) != ((8, 256), (10, -30),
                                                                   (1.0, 56.0)):
            raise AssertionError("coarse: from_config did not take the YAML's geometry")
        n_attn = sum(isinstance(m, SelfAttentionBlock) for m in model.unet.modules())
        unet_norms = sum(isinstance(m, Normalize) for m in model.unet.modules())
        dec_norms = sum(isinstance(m, Normalize)
                        for m in model.first_stage_model.decoder.modules())
        hooked = self._coarse_shapes()["request"]
        for sampler, steps in (("dpm", 20), ("ddim", 50)):
            pipe.sampler, pipe.steps = sampler, steps
            pipe.generate(BATCH, seed=99)        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = pipe.generate(N_MAIN, seed=0, batch=BATCH)
            got = read_counts()
            batches, evals = N_MAIN // BATCH, unet_evals(model, steps)
            want = {k: 0 for k in counters()}
            want.update(flash_attention=batches * evals * n_attn,
                        group_norm=batches * (evals * unet_norms + dec_norms))
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            imgs = res.images
            drop = float((imgs == -1.0).mean())
            log(f"coarse {sampler}-{steps} (generate({N_MAIN}), batch {BATCH}, bf16): images "
                f"{imgs.shape} finite={bool(np.isfinite(imgs).all())} ray-drop share {drop:.4f}; "
                f"clouds {len(res.clouds)} (median {int(np.median([len(c) for c in res.clouds]))}"
                f" points); {res.samples_per_sec:.3f} samples/s; phases "
                + ", ".join(f"{k} {v:.4f} s" for k, v in res.phase_seconds.items())
                + f"; peak memory {mem:.2f} GiB; launches {got}, structure {want} ({n_attn} "
                f"attention blocks and {unet_norms} norms a U-Net eval, {evals} evals, "
                f"{dec_norms} decoder norms); card {card}")
            if imgs.shape != (N_MAIN, 8, 256, 1) or not np.isfinite(imgs).all() \
                    or len(res.clouds) != N_MAIN or not 0 < drop < 1:
                raise AssertionError(f"coarse {sampler}: bad output")
            if got != want:
                raise AssertionError(f"coarse {sampler}: launches {got} != structure {want}")
            if sampler == "dpm":
                per_request = {"flash_attention": sum(hooked["flash_attention"].values()),
                               "group_norm": sum(hooked["group_norm"].values())}
                if {k: v * batches for k, v in per_request.items()} != \
                        {k: got[k] for k in per_request}:
                    raise AssertionError(f"coarse: launches {got} != module hooks "
                                         f"{per_request} a request")
                self.coarse_launches = got
        del pipe, model
        gc.collect()
        torch.cuda.empty_cache()

    def _coarse_train(self):
        """The coarse LiDM's training step at batch 16, bf16 autocast, f32
        weights, synthetic 8x256 scenes: steps/s, the phase split, peak
        memory, launches per step against the structure (every U-Net
        attention forward and backward, every U-Net norm forward and
        backward, every frozen VQ encoder norm forward) and module hooks, no
        plain GroupNorm backward, finite losses."""
        import torch
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        card = card_line()
        batches = self._coarse_batches(3, TRAIN_BATCH)
        model = self._coarse_ldm()
        params = DT.trainable_params(model)
        state = DT.create_train_state(model, DT.make_optimizer(params, COARSE_LR), params)
        step = DT.make_train_step(model, autocast_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        n_attn = sum(isinstance(m, SelfAttentionBlock) for m in model.unet.modules())
        unet_norms = sum(isinstance(m, Normalize) for m in model.unet.modules())
        enc_norms = sum(isinstance(m, Normalize)
                        for m in model.first_stage_model.encoder.modules())
        structure = {k: 0 for k in counters()}
        structure.update(flash_attention=n_attn, flash_attention_bwd=n_attn,
                         group_norm=unet_norms + enc_norms, group_norm_bwd=unet_norms)
        hooked = {k: sum(v.values()) for k, v in self._coarse_shapes()["train"].items()}
        step(state, batches[0], gen)
        step(state, batches[1], gen)                    # two warm-ups
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        plain, real = [0], G._group_norm_bwd_ref

        def counting(*a, **k):
            plain[0] += 1
            return real(*a, **k)
        G._group_norm_bwd_ref = counting
        try:
            t0 = time.perf_counter()
            losses = []
            for i in range(TRAIN_STEPS):
                state, logs = step(state, batches[i % len(batches)], gen)
                losses.append(logs["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            G._group_norm_bwd_ref = real
        got = read_counts()
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = {k: v / TRAIN_STEPS for k, v in got.items()}
        timed = DT.make_train_step(model, autocast_dtype=torch.bfloat16, timed=True)
        phases = collections.Counter()
        for i in range(3):
            state, tl = timed(state, batches[i], gen)
            for k in ("encode", "fwd_bwd", "opt_ema"):
                phases[k] += tl[f"seconds_{k}"] / 3
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        log(f"coarse train (LiDM, batch {TRAIN_BATCH}, bf16 autocast, f32 weights, "
            f"{TRAIN_STEPS} steps): {TRAIN_STEPS / wall:.3f} steps/s, "
            f"{TRAIN_STEPS * TRAIN_BATCH / wall:.2f} samples/s; phases per step (synchronised): "
            f"encode {phases['encode']:.4f} s, forward+backward {phases['fwd_bwd']:.4f} s, "
            f"optimizer+EMA {phases['opt_ema']:.4f} s; peak memory {mem:.2f} GiB; launches per "
            f"step {per_step} (structure {structure}, hooks {hooked}); plain GroupNorm backward "
            f"calls {plain[0]}; last loss {float(losses[-1]):.5f} finite={finite}; card {card}")
        if per_step != {k: float(v) for k, v in structure.items()} or hooked != structure:
            raise AssertionError(f"coarse train: launches per step {per_step}, hooks {hooked}, "
                                 f"structure {structure} differ")
        if plain[0] or not finite:
            raise AssertionError("coarse train: the plain GroupNorm backward ran, or a loss "
                                 "is not finite")
        self.coarse_train_launches = got
        del model, state, step, timed, batches
        gc.collect()
        torch.cuda.empty_cache()

    def _coarse_cli(self):
        """train_lidm --synthetic on the card: range_256x8.yaml and
        range_flow.yaml for 2 steps each (f32, batch 4, accumulate 2; the
        image logger on), then the coarse LiDM YAML for 2 steps over the
        coarse AE run's checkpoint (its ddconfig without the mask head, as
        the flagship's first stage over the kitti AE run), with the logger's
        DDIM inpainting."""
        import torch
        from lidar_layout_tpu_torch.train import checkpoint as CK
        from lidar_layout_tpu_torch.train import train_lidm as TL

        tmp = self.tmp_dir("coarse_")
        fs = "model.params.first_stage_config.params."
        runs = (("range_256x8", COARSE_AE_YAML, []), ("range_flow", RANGE_FLOW_YAML, []),
                ("coarse_ldm", COARSE_LDM_YAML,
                 [f"{fs}ckpt_path=" + CK.checkpoint_path(os.path.join(tmp, "range_256x8",
                                                                      "ckpt"), 2),
                  f"{fs}use_mask=false", f"{fs}ddconfig.out_ch=1", "--bf16"]))
        for name, yaml_path, extra in runs:
            run = os.path.join(tmp, name)
            t0 = time.perf_counter()
            trainer = TL.main(["-b", yaml_path, "--synthetic", "--steps", "2", "--workdir", run,
                               *extra])
            dev = next(trainer.state.model.parameters()).device
            images = sorted(os.listdir(os.path.join(run, "images")))
            with open(os.path.join(run, "metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
            log(f"coarse: train_lidm -b {os.path.relpath(yaml_path, HERE)} --synthetic --steps 2 "
                f"{' '.join(extra)} in {time.perf_counter() - t0:.1f} s on {dev}; images "
                f"{images[:8]}...; last metrics {last}")
            val = [v for k, v in last.items() if k.startswith("val/")]
            if trainer.global_step != 2 or dev.type != "cuda" or not images or not val \
                    or not all(np.isfinite(val)):
                raise AssertionError(f"coarse: the CLI did not train {name} on the card")
            if name == "coarse_ldm" and "samples_inpainting_0000002.npy" not in images:
                raise AssertionError("coarse: the LiDM's image logger wrote no inpainting")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

    # ------------------------------------------------------- the cube stage
    @staticmethod
    def _cube_ldm(device="cuda"):
        """The cube latent diffusion of its YAML with its first stage (the
        voxel_1024 SparseVAE), torch's initial weights under seed 0, the
        zero-initialised layers (each attention's ``proj``, the U-Net's
        ``out``) lifted to N(0, 0.05) so that a comparison sees every layer."""
        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = instantiate_from_config(load_yaml(VOXEL_LDM_YAML)["model"])
            with torch.no_grad():
                for p in model.unet.parameters():
                    if not p.any():
                        torch.nn.init.normal_(p, std=0.05)
            return model.to(device)

    @staticmethod
    def _clouds(n, seed, device="cuda"):
        """``n`` synthetic nusc_cube clouds of CUBE_POINTS points (the
        factory's fallback), as tensors."""
        import torch
        from lidar_layout_tpu_torch.data.factory import synthetic_cloud_batch

        raw = synthetic_cloud_batch(np.random.default_rng(seed), n, CUBE_POINTS)
        return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}

    def cube_slice(self):
        """The cube stage card against CPU at the full voxel_1024.yaml config
        (the first stage of voxel_uncond_diffusion_256.yaml, which is the
        same) on 2 synthetic clouds of 32,768 points, f32, TF32 off, from the
        same weights and fed draws: the grids of every level, the point-to-
        voxel map and the occupancy targets integer for integer; the
        latent, the struct logits and the decoded features within 1e-4
        relative L2; struct_loss per cloud within 1e-5 relative; the
        SparseVAE's gradients within 1e-4 relative L2. Then, on the CPU's
        latent grids: CubeDiffusion.p_losses with fed t and noise within
        1e-5, the U-Net's gradients within 1e-4 relative L2, and a DDIM-5
        from a fed x_T within 1e-4 relative L2, zero at padding rows."""
        import torch
        from lidar_layout_tpu_torch.config import cube_vae_cfg, load_yaml
        from lidar_layout_tpu_torch.models.sparse_vae import struct_loss
        from lidar_layout_tpu_torch.ops import voxel as V

        clouds = self._clouds(2, 4, "cpu")
        ref = self._cube_ldm("cpu")
        # the diffusion YAML's first stage is voxel_1024.yaml's VAE, whose
        # loss block (kl_weight 0.3) it leaves out
        vcfg = cube_vae_cfg(load_yaml(VOXEL_YAML)["model"]["params"])
        if dataclasses.replace(ref.first_stage_model.cfg, kl_weight=vcfg.kl_weight) != vcfg:
            raise AssertionError("cube_slice: voxel_1024.yaml and the diffusion YAML's first "
                                 "stage differ")
        sd = ref.state_dict()
        gen = torch.Generator().manual_seed(5)
        top = vcfg.capacity(vcfg.num_levels - 1)
        noise, eps, x_T = (torch.randn((2, top, vcfg.latent_dim), generator=gen)
                           for _ in range(3))
        t = torch.tensor([37, 612])
        runs, grid_c, z_c = {}, None, None
        for dev in ("cpu", "cuda"):
            model = ref if dev == "cpu" else self._cube_ldm("cuda")
            model.load_state_dict(sd)
            vae = model.first_stage_model
            b = {k: v.to(dev) for k, v in clouds.items()}
            t0 = time.perf_counter()
            out = vae(b["points"], b["feats"], b["mask"], noise=noise.to(dev))
            losses, _ = struct_loss(out, vcfg.kl_weight)
            losses.mean().backward()
            _, p2v, cells = V.voxelize_points(b["points"], b["mask"], vcfg.voxel_size,
                                              vcfg.capacity(0))
            if grid_c is None:
                grid_c = V.VoxelGrid(*(a.detach() for a in out["latent_grid"]))
                z_c = out["latent"].detach()
            grid = V.VoxelGrid(*(a.to(dev) for a in grid_c))
            dloss, _ = model.p_losses(grid, z_c.to(dev), t=t.to(dev), noise=eps.to(dev))
            dloss.mean().backward()
            zs = model.ddim_sample(grid, steps=5, x_T=x_T.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = {
                "ints": [a.cpu() for g in out["grids"] for a in g]
                + [a.cpu() for a in out["struct_targets"]] + [p2v.cpu()],
                "floats": {"latent": out["latent"], "decoded_feats": out["decoded_feats"],
                           **{f"struct_logits_{i}": a for i, a in
                              enumerate(out["struct_logits"])}, "ddim5": zs},
                "losses": {"struct_loss": losses, "p_losses": dloss},
                "grads": {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                          for n, p in model.named_parameters()},
                "fill": [(int(g.mask[i].sum()), int(V.count_unique(cells >> lvl,
                                                                     b["mask"])[i]))
                         for i in range(2) for lvl, g in enumerate(out["grids"])]}
            runs[dev]["floats"] = {k: v.detach().cpu() for k, v in runs[dev]["floats"].items()}
            runs[dev]["losses"] = {k: v.detach().cpu() for k, v in runs[dev]["losses"].items()}
            log(f"cube_slice on {dev}: {time.perf_counter() - t0:.1f} s; struct_loss "
                f"{runs[dev]['losses']['struct_loss'].tolist()}, p_losses "
                f"{runs[dev]['losses']['p_losses'].tolist()}; (rows used, distinct cells) by "
                f"cloud and level {runs[dev]['fill']}")
            del model, vae, out
        g, c = runs["cuda"], runs["cpu"]
        ints_ok = all(torch.equal(a, b_) for a, b_ in zip(g["ints"], c["ints"]))
        rel = {k: float((g["floats"][k] - v).norm() / v.norm()) for k, v in c["floats"].items()}
        lrel = {k: float(((g["losses"][k] - v).abs() / v.abs()).max())
                for k, v in c["losses"].items()}
        grads = {}
        for part, pred in (("SparseVAE", lambda k: k.startswith("first_stage_model.")),
                           ("U-Net", lambda k: k.startswith("unet."))):
            keys = [k for k in c["grads"] if pred(k)]
            num = sum(float((g["grads"][k] - c["grads"][k]).square().sum()) for k in keys)
            den = sum(float(c["grads"][k].square().sum()) for k in keys)
            grads[part] = (num / den) ** 0.5 if den > 0 else float("inf")
        pad_zero = not bool(g["floats"]["ddim5"][~grid_c.mask].any())
        ok = (ints_ok and all(v <= 1e-4 for v in rel.values())
              and all(v <= 1e-5 for v in lrel.values()) and all(v <= 1e-4 for v in grads.values())
              and pad_zero and all(bool(torch.isfinite(v).all()) for v in g["floats"].values()))
        log(f"cube_slice (voxel_1024.yaml, 2 clouds of {CUBE_POINTS} points, f32): integers "
            f"equal (grids of {vcfg.num_levels} levels, struct targets, point-to-voxel) "
            f"{ints_ok}; relative L2 errors {rel} (tol 1e-4); losses' relative errors {lrel} "
            f"(tol 1e-5); gradients' relative L2 {grads} (tol 1e-4); DDIM-5 zero at padding "
            f"{pad_zero}: {'correct' if ok else 'NOT correct'}")
        if not ok:
            raise AssertionError("cube_slice: the card's cube stage disagrees with the CPU's")
        gc.collect()
        torch.cuda.empty_cache()

    def cube(self):
        """The cube stage through train_lidm on the card: voxel_1024.yaml for
        TRAIN_STEPS steps at batch 4 (32,768-point synthetic clouds), then
        voxel_uncond_diffusion_256.yaml for TRAIN_STEPS steps over that run (its
        first stage from the run's checkpoint), autoencoder_cube.yaml for 2
        steps. Then, on each trained state: TRAIN_STEPS timed steps after 2 warm-ups
        (steps/s, clouds/s, peak memory), the level fill per cloud (rows
        used against capacity, and the distinct cells each level would
        need), a DDIM-50 over the 4 encoded grids (finite, zero at padding),
        and the kernel launches (none: JAX runs no Pallas kernel on this
        path, and the port none)."""
        import torch
        from lidar_layout_tpu_torch.ops import voxel as V
        from lidar_layout_tpu_torch.train import train_lidm as TL

        card = card_line()
        tmp = self.tmp_dir("cube_")
        trainers = {}
        for name, yaml_path, steps, extra in (
                ("voxel_1024", VOXEL_YAML, TRAIN_STEPS, []),
                ("voxel_uncond_diffusion_256", VOXEL_LDM_YAML, TRAIN_STEPS,
                 ["model.params.first_stage_config.params.ckpt_path="
                  + os.path.join(tmp, "voxel_1024")]),
                ("autoencoder_cube", CUBE_AE_YAML, 2, [])):
            run = os.path.join(tmp, name)
            t0 = time.perf_counter()
            trainer = TL.main(["-b", yaml_path, "--synthetic", "--steps", str(steps),
                               "--workdir", run, *extra])
            dev = next(trainer.state.model.parameters()).device
            with open(os.path.join(run, "metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
            log(f"cube: train_lidm -b {os.path.relpath(yaml_path, HERE)} --synthetic --steps "
                f"{steps} in {time.perf_counter() - t0:.1f} s on {dev}; last metrics {last}")
            val = [v for k, v in last.items() if k.startswith("val/")]
            if trainer.global_step != steps or dev.type != "cuda" or not val \
                    or not all(np.isfinite(val)):
                raise AssertionError(f"cube: the CLI did not train {name} on the card")
            trainers[name] = trainer
        ldm = trainers["voxel_uncond_diffusion_256"].state.model
        ae_sd = trainers["voxel_1024"].state.model.state_dict()
        if not all(torch.equal(v, ae_sd[k]) for k, v in ldm.first_stage_model.state_dict()
                   .items()):
            raise AssertionError("cube: the diffusion's first stage is not the AE run's")
        del trainers["autoencoder_cube"]
        batches = [self._clouds(CUBE_BATCH, 20 + i) for i in range(3)]
        reset_counts()
        for name, trainer in trainers.items():
            state, gen = trainer.state, trainer.generator
            for i in range(2):
                state, _ = trainer.step_fn(state, batches[i], gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses = []
            for i in range(TRAIN_STEPS):
                state, logs = trainer.step_fn(state, batches[i % len(batches)], gen)
                losses.append(logs["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            finite = bool(torch.isfinite(torch.stack(losses)).all())
            log(f"cube {name} step (batch {CUBE_BATCH} of {CUBE_POINTS} points, f32, "
                f"{TRAIN_STEPS} steps): {TRAIN_STEPS / wall:.3f} steps/s, "
                f"{TRAIN_STEPS * CUBE_BATCH / wall:.2f} clouds/s; peak memory {mem:.2f} GiB; "
                f"last loss {float(losses[-1]):.5f} finite={finite}; card {card}")
            if not finite:
                raise AssertionError(f"cube {name}: a loss is not finite")
        vae = ldm.first_stage_model
        cfg = vae.cfg
        with torch.no_grad():
            b = batches[0]
            out = vae(b["points"], b["feats"], b["mask"],
                      generator=torch.Generator(device="cuda").manual_seed(1))
            _, _, cells = V.voxelize_points(b["points"], b["mask"], cfg.voxel_size,
                                            cfg.capacity(0))
            fill = [[(int(g.mask[i].sum()), cfg.capacity(lvl),
                      int(V.count_unique(cells >> lvl, b["mask"])[i]))
                     for lvl, g in enumerate(out["grids"])] for i in range(CUBE_BATCH)]
            past = float((cells >= (1 << cfg.bits) - 1).any(-1)[b["mask"]].float().mean())
            grid = out["latent_grid"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            zs = ldm.ddim_sample(grid, steps=CUBE_DDIM,
                                 generator=torch.Generator(device="cuda").manual_seed(2))
            torch.cuda.synchronize()
            ddim_s = time.perf_counter() - t0
        full = all(used == cap for cl in fill for used, cap, _ in cl)
        finite = bool(torch.isfinite(zs).all())
        pad_zero = not bool(zs[~grid.mask].any())
        got = read_counts()
        log(f"cube level fill by cloud, (rows used, capacity, distinct cells) at levels 0-2: "
            f"{fill}; every level full: {full}; share of points at the 10-bit clip "
            f"(coord 1023): {past:.4f}")
        log(f"cube DDIM-{CUBE_DDIM} over the {CUBE_BATCH} encoded grids ({tuple(zs.shape)}): "
            f"{ddim_s:.3f} s, {CUBE_BATCH / ddim_s:.3f} grids/s; finite={finite}, zero at "
            f"padding {pad_zero}; kernel launches over the timed steps and DDIM {got} (the "
            f"cube path runs none)")
        if not finite or not pad_zero:
            raise AssertionError("cube: DDIM-50 gave non-finite latents or wrote padding rows")
        if any(got.values()):
            raise AssertionError(f"cube: kernels launched on a path that has none: {got}")
        self.cube_launches = got
        del trainers, ldm, vae, out, zs, batches
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------ "Ours" stage 3, dense
    @staticmethod
    def _dense_geom():
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.train.train_dense_decoder import dense_geometry

        return dense_geometry(load_yaml(DENSE_YAML)["data"]["params"]["dataset"])

    @staticmethod
    def _dense_model(device="cuda"):
        """gaus_10cm.yaml's DenseDecoder at full width (PT-v3 32-512, patch
        1024; surfel heads 64 wide) for the data's 4-wide feats (the YAML
        says 3), torch's initialisers under seed 0, as the CLI builds it."""
        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = instantiate_from_config(load_yaml(DENSE_YAML)["model"], in_features=4)
        return model.to(device)

    def _dense_yaml_lr(self, geom, rc, sample):
        """A dead-decoder check at the YAML's lr (2e-3): fresh weights,
        DENSE_LIVE_STEPS steps of train_dense_decoder's step on one cloud;
        before the first step and after each, the share of pixels whose
        alpha exceeds 1e-3 and of valid surfels with a positive opacity.
        A decoder whose every surfel is transparent reads 0 and gets no
        gradient back. Both packages' decoders collapse at this lr with no
        warm-up, from JAX's initial weights too (tests/dense_lr_probe.py),
        so the gate holds the first DENSE_LIVE_GATED steps only."""
        import torch
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.models.gs_decoder import render_surfels
        from lidar_layout_tpu_torch.train import train_dense_decoder as TD

        opt = load_yaml(DENSE_YAML)["optimizer"]
        model = self._dense_model()
        state = TD.create_dense_state(model, opt["lr"], opt["weight_decay"])
        step = TD.make_dense_train_step(model, geom, rc)
        live = []
        for i in range(DENSE_LIVE_STEPS + 1):
            with torch.no_grad():
                surfels = model(sample["points"], sample["feats"], sample["mask"])
                alpha = render_surfels(surfels, geom, rc)["alpha"]
                live.append((float((alpha > 1e-3).float().mean()),
                             float((surfels["opacities"][surfels["mask"]] > 0).float().mean())))
            if i < DENSE_LIVE_STEPS:
                state, logs = step(state, sample, None)
                live[-1] += (float(logs["loss"]),)
        log(f"dense at the YAML's lr {opt['lr']:g} (fresh weights, one cloud): share of pixels "
            f"with alpha > 1e-3, of surfels with opacity > 0 and the loss, before the first "
            f"step and after each of {DENSE_LIVE_STEPS}: "
            + "; ".join(" ".join(f"{v:.5g}" for v in row) for row in live))
        dead = [i for i, row in enumerate(live[:DENSE_LIVE_GATED + 1])
                if not row[0] >= DENSE_LIVE_SHARE]
        if dead:
            raise AssertionError(f"dense: at the YAML's lr the decoder is dead (alpha > 1e-3 on "
                                 f"under {DENSE_LIVE_SHARE:g} of the pixels) after steps {dead}")
        del model, state, step

    def _dense_samples(self, n, seed, points=DENSE_POINTS, device="cuda"):
        """``n`` samples of the CLI's data path: nusc_cube_decode's synthetic
        clouds of ``points`` points (no root), each with its pcd2range
        ground truth (train_dense_decoder.to_sample)."""
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.data.factory import build_batches
        from lidar_layout_tpu_torch.train.train_dense_decoder import to_sample

        dset = load_yaml(DENSE_YAML)["data"]["params"]["dataset"]
        raw = build_batches("nusc_cube_decode", {"max_points": points}, dset, None, 1,
                            seed=seed, force_synthetic=True, device=device)
        return [to_sample(next(raw), self._dense_geom()) for _ in range(n)]

    @staticmethod
    def _dense_shapes(points=DENSE_POINTS):
        """K1's (B, H, S, D) calls of one dense-decoder forward, from
        gaus_10cm.yaml's PT-v3 (_ptv3_shapes)."""
        from lidar_layout_tpu_torch.config import build_ptv3_cfg, load_yaml

        cfg = build_ptv3_cfg(load_yaml(DENSE_YAML)["model"]["params"]["backbone"]["params"])
        return Smoke._ptv3_shapes(cfg, points)

    @staticmethod
    def _dense_hooks(model):
        """Forward pre-hooks on every PatchAttention: K1 calls by (B, H, S, D)
        as the blocks hand them over, and K2 once for each that needs grad."""
        import torch
        from lidar_layout_tpu_torch.models.ptv3 import PatchAttention

        seen = {"flash_attention": collections.Counter(),
                "flash_attention_bwd": collections.Counter()}

        def hook(mod, args):
            x, _, patch = args[:3]
            key = (-(-x.shape[0] // patch), mod.heads, patch, x.shape[1] // mod.heads)
            seen["flash_attention"][key] += 1
            if torch.is_grad_enabled():
                seen["flash_attention_bwd"][key] += 1
        return seen, [m.register_forward_pre_hook(hook) for m in model.modules()
                      if isinstance(m, PatchAttention)]

    def _gaus_ae_shapes(self):
        """K3's (forward, backward) calls of one Gaussian-AE step (batch 4,
        32x1024, the s2 branch) by shape: the dense phase's hooks, or hooks
        on one step taken here when it did not run."""
        if self.gaus_ae_shapes is None:
            import torch
            from torch_port_helpers import count_group_norms

            model, disc, loss_cfg, geo, state = self._ae_setup(yaml_path=GAUS_AE_YAML)
            with count_group_norms(model, disc) as shapes:
                ae_step(model, disc, loss_cfg, geo)(
                    state, self._ae_batches(1, yaml_path=GAUS_AE_YAML)[0],
                    torch.Generator(device="cuda").manual_seed(0))
            self.gaus_ae_shapes = shapes
            del model, disc, state
            gc.collect()
            torch.cuda.empty_cache()
        return self.gaus_ae_shapes

    def _kernels_dense(self):
        """K1 and K2 at the dense decoder's PT-v3 shapes at 8192 points (head
        dim 16; 22 calls a forward; _kernels_ptv3_attention), then K3
        forward and backward in f32 at every group shape of the Gaussian
        AE's training step."""
        self._kernels_ptv3_attention(self._dense_shapes(), "dense",
                                     "the dense decoder's attention shapes", 13)
        self._kernels_ae(self._gaus_ae_shapes(), "gaus_ae", "the Gaussian AE's training step")

    def _kernels_ptv3_attention(self, shapes, key, label, seed):
        """K1 and K2 in f32 at every PT-v3 attention shape of ``shapes``
        ((B, H, S, D) -> calls a forward), on q, k and v laid out as
        PatchAttention hands them over (views of one (B, S, 3, H, D)
        projection), each with two key biases: a ragged padding tail (the
        last third of the last patch's keys at -1e9) and a patch of padding
        alone (every key of the last patch at -1e9, whose softmax is
        uniform, as _attend_ref's: the mean of v). K1 (and its log-sum-exp)
        and K2 against the plain versions, each bit for bit over two
        launches; the errors go to ``<key>_<kernel>``."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        log(f"K1 and K2 at {label} (f32, kbias; calls a forward "
            f"{dict(sorted(shapes.items()))}):")
        for (b, h, s, d), count in sorted(shapes.items()):
            for case in ("ragged padding tail", "a patch of padding alone"):
                qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev)
                q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                do = torch.randn((b, h, s, d), generator=gen, device=dev)
                kb = torch.zeros((b, s), device=dev)
                if case.startswith("ragged"):
                    kb[-1, s - s // 3:] = -1e9
                else:
                    kb[-1] = -1e9
                what = f"{(b, h, s, d)} f32, {case} (x{count} a forward)"
                got = A.flash_attention(q, k, v, kb)
                self._check_key(key, "flash_attention", got, A._attend_ref(q, k, v, kb), 2e-5,
                                1e-4, what)
                o, lse = A._launch(q, k, v, kb, with_lse=True)
                o2, lse2 = A._launch(q, k, v, kb, with_lse=True)
                err, scale = max_err(lse, A._lse_ref(q, k, kb))
                grads = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
                for part, g_, w_ in zip(("dq", "dk", "dv"), grads,
                                        A._attend_bwd_ref(q, k, v, o, do, lse, kb)):
                    self._check_key(key, "flash_attention_bwd", g_, w_, 1e-4, 1e-4,
                                    f"{part} {what}")
                again = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
                torch.cuda.synchronize()
                same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                        and all(torch.equal(a_, g_) for a_, g_ in zip(again, grads)))
                mean_err = (max_err(o[-1], v[-1].mean(dim=1, keepdim=True).expand_as(v[-1]))[0]
                            if case.startswith("a patch") else 0.0)
                log(f"  {what}: lse max_abs_err {err:.3e} (tol 2e-4+1e-5*|ref|); two launches "
                    f"of K1 and of K2 bit for bit equal: {same}"
                    + (f"; the padding patch's output against the mean of its v: "
                       f"max_abs_err {mean_err:.3e} (tol 1e-5)" if mean_err else ""))
                if not same or not err <= 2e-4 + 1e-5 * scale or not mean_err <= 1e-5:
                    raise AssertionError(f"K1/K2 at {what}: log-sum-exp off, a padding patch "
                                         f"not uniform, or not deterministic")
                del qkv, q, k, v, do, o, o2, grads, again
        torch.cuda.empty_cache()

    def _check_key(self, key, name, got, want, atol, rtol, what):
        self._check(name, got, want, atol, rtol, what, record=False)
        err_key = f"{key}_{name}"
        self.kernel_err[err_key] = max(self.kernel_err.get(err_key, 0.0), max_err(got, want)[0])

    @staticmethod
    def _ptv3_ints(backbone, points, mask):
        """PT-v3's integers for one cloud, level by level: the grid, the
        sort orders along the four curves and their inverses, the segment
        of each row and the row mask of the pooled level."""
        from lidar_layout_tpu_torch.models.ptv3 import _serial_orders

        out = []
        for grid, m, seg in backbone.pooled_levels(points, mask):
            out += [grid, m, *_serial_orders(grid, m, backbone.cfg.orders, backbone.cfg.bits)]
            if seg is not None:
                out.append(seg)
        return [t.cpu() for t in out]

    def dense_slice(self):
        """"Ours" stage 3 card against CPU, f32, TF32 off, from the same
        weights. At the CLI's 8192 points: PT-v3's integers equal (the grid,
        the orders along the four curves and their inverses, the pooled
        segments and masks of every level), its features and the surfels
        within 1e-5 relative L2, the banded render within 1e-4 (a render's
        alpha thresholds flip on last-bit differences: the card read
        1.7e-5-5.7e-5). At 1024 points (the CPU renders about 0.6 s a chunk
        of 512 surfels over 32x1024 pixels): the dense and the surfel
        rasterizers' renders within 1e-4 and gs_loss's parts within 1e-5
        relative; one
        train_dense_decoder step (RasterConfig chunk 512): loss parts within
        1e-5, the gradients within 1e-4 relative L2, the parameters after
        clip + AdamW within 2 lr, under 1e-3 of the elements with a live
        gradient off by more than 0.01 lr. Then the Gaussian AE's VQ-GAN
        step with the s2 branch at step 0 under ae_train_slice's gates,
        two of them wider (_compare_ae_runs), with the TF32 control at step 0
        (full width, batch 4 of 32x256 images: the s2 render grows with the
        square of the pixels)."""
        import torch
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.models.gs_decoder import gs_loss, render_surfels
        from lidar_layout_tpu_torch.ops.gaussian_raster import RasterConfig, SurfelConfig
        from lidar_layout_tpu_torch.ops.gaussian_raster_tiled import BandedConfig
        from lidar_layout_tpu_torch.train import train_dense_decoder as TD

        geom = self._dense_geom()
        opt = load_yaml(DENSE_YAML)["optimizer"]
        lr = opt["lr"]
        ref = self._dense_model("cpu")
        models = {"cpu": ref, "cuda": self._dense_model("cuda")}
        models["cuda"].load_state_dict(ref.state_dict())
        full = self._dense_samples(1, 4, device="cpu")[0]
        small = self._dense_samples(1, 5, points=DENSE_SLICE_POINTS, device="cpu")[0]
        runs = {}
        for dev, model in models.items():
            t0 = time.perf_counter()
            run = {}
            s = {k: v.to(dev) for k, v in full.items()}
            feats = {}
            hook = model.backbone.register_forward_hook(lambda m, a, o: feats.update(h=o[0]))
            with torch.no_grad():
                run["ints"] = self._ptv3_ints(model.backbone, s["points"], s["mask"])
                surfels = model(s["points"], s["feats"], s["mask"])
                run["floats"] = {"ptv3": feats["h"], **{f"surfels.{k}": v for k, v in
                                                       surfels.items() if k != "mask"}}
                banded = render_surfels(surfels, geom, BandedConfig())
                run["banded"] = {f"banded.{k}": v for k, v in banded.items()}
                run["ints"].append(surfels["mask"].cpu())
                s = {k: v.to(dev) for k, v in small.items()}
                surfels = model(s["points"], s["feats"], s["mask"])
                run["losses"] = {}
                for name, cfg in (("dense", RasterConfig(chunk=512)),
                                  ("surfel", SurfelConfig(chunk=512))):
                    r = render_surfels(surfels, geom, cfg)
                    run["floats"].update({f"{name}.{k}": v for k, v in r.items()})
                    run["losses"].update({f"{name}.{k}": v for k, v in
                                          gs_loss(r, s["gt_range"], s["gt_mask"])[1].items()})
            hook.remove()
            state = TD.create_dense_state(model, lr, opt["weight_decay"])
            real = state.optimizer.step

            def spy(gs, real=real):
                run["grads"] = {n: g_.detach().cpu().clone()
                                for (n, _), g_ in zip(model.named_parameters(), gs)}
                return real(gs)
            state.optimizer.step = spy
            _, logs = TD.make_dense_train_step(model, geom, RasterConfig(chunk=512))(
                state, s, None)
            run["losses"].update({f"step.{k}": v for k, v in logs.items()})
            run["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            for part in ("floats", "banded", "losses"):
                run[part] = {k: v.detach().float().cpu() for k, v in run[part].items()}
            runs[dev] = run
            log(f"dense_slice on {dev}: {time.perf_counter() - t0:.1f} s; losses "
                + ", ".join(f"{k} {float(v):.6g}" for k, v in sorted(run["losses"].items())))
        g, c = runs["cuda"], runs["cpu"]
        ints_ok = len(g["ints"]) == len(c["ints"]) and all(
            torch.equal(a, b) for a, b in zip(g["ints"], c["ints"]))
        rel = {k: float((g["floats"][k] - v).norm() / v.norm().clamp(min=1e-30))
               for k, v in c["floats"].items()}
        brel = {k: float((g["banded"][k] - v).norm() / v.norm().clamp(min=1e-30))
                for k, v in c["banded"].items()}
        lrel = {k: abs(float(g["losses"][k]) - float(v)) / max(abs(float(v)), 1e-30)
                for k, v in c["losses"].items()}
        names = list(c["grads"])
        num = sum(float((g["grads"][n] - c["grads"][n]).square().sum()) for n in names)
        den = sum(float(c["grads"][n].square().sum()) for n in names)
        grel = (num / den) ** 0.5
        ref_g = torch.cat([c["grads"][n].flatten() for n in names])
        diff = torch.cat([(g["params"][n] - c["params"][n]).abs().flatten() for n in names])
        live = ref_g.abs() > 1e-6 * ref_g.abs().max()
        far = float((diff[live] > 0.01 * lr).float().mean())
        finite = all(bool(torch.isfinite(v).all()) for v in g["floats"].values())
        # a render's alpha thresholds (1/255, the 3-sigma cutoff) flip where a
        # surfel's f32 inputs differ in the last bits: renders are held to 1e-4
        render = {k: v for k, v in rel.items() if k.split(".")[0] in ("dense", "surfel")}
        ok = (ints_ok and finite
              and all(v <= (1e-4 if k in render else 1e-5) for k, v in rel.items())
              and all(v <= 1e-4 for v in brel.values())
              and all(v <= 1e-5 for v in lrel.values()) and grel <= 1e-4
              and float(diff.max()) <= 2 * lr and far <= 1e-3)
        log(f"dense_slice ({os.path.relpath(DENSE_YAML, HERE)}, f32, TF32 off): integers equal "
            f"({len(c['ints'])} tensors: grids, curve orders and inverses, segments and masks "
            f"of 5 levels, the surfel mask) {ints_ok}; relative L2 {rel} (tol 1e-5, the dense "
            f"and surfel renders 1e-4); banded render at {DENSE_POINTS} points {brel} (tol "
            f"1e-4); losses' relative errors "
            f"{lrel} (tol 1e-5); the step's gradients relative L2 {grel:.3e} (tol 1e-4); "
            f"parameters after clip + AdamW max_abs_err {float(diff.max()):.3e} (tol 2 lr = "
            f"{2 * lr:g}), share of live elements off by > 0.01 lr {far:.2e} (tol 1e-3): "
            f"{'correct' if ok else 'NOT correct'}")
        if not ok:
            raise AssertionError("dense_slice: the card's dense decoder disagrees with the CPU's")
        del models, ref, runs
        gc.collect()
        torch.cuda.empty_cache()
        # step 0 alone: past disc_start the GAN-off branch is the kitti AE's
        # (ae_train_slice); the s2 render loss is the same at both steps
        self._ae_slice("dense_slice Gaussian AE", GAUS_AE_YAML, tf32_control=True,
                       overrides=GAUS_SLICE, steps=(0,))

    def dense(self):
        """"Ours" stage 3 on the card at full width, f32 (TF32 off). Serving:
        the dense decoder's decode (PT-v3, surfels, the RasterConfig render
        at 32x1024) of one 8192-point synthetic cloud, 2 warm-ups (the first
        under hooks) then DECODE_CLOUDS timed decodes: clouds/s, the split
        PT-v3 / raster, peak memory, K1 launches (22 a decode) against the
        structure and the hooks, finite (32, 1024) images, the valid rows of
        every level. Training: train_dense_decoder --synthetic --steps 2
        (the CLI on the card), then its step: 2 warm-ups, TRAIN_STEPS timed
        steps (steps/s, K1 + K2 22 + 22 a step against the structure and
        the hooks, peak memory), the split PT-v3 / raster / loss+backward /
        optimizer over 3 synchronised steps, a falling loss over
        DENSE_OVERFIT_STEPS steps on one cloud at lr 1e-4, and the dead-decoder
        check at the YAML's lr (_dense_yaml_lr). Then the Gaussian
        AE (autoencoder_c2_p4_gaus.yaml) at batch 4, accumulate 2: GAUS_STEPS
        of ae_train's timed steps, its phase split on one synchronised step,
        K3 launches against the structure and hooks, and train_lidm
        --synthetic --steps 1 on the YAML."""
        import torch
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.models.gs_decoder import render_surfels
        from lidar_layout_tpu_torch.ops.gaussian_raster import RasterConfig
        from lidar_layout_tpu_torch.train import train_dense_decoder as TD
        from lidar_layout_tpu_torch.train import train_lidm as TL

        card = card_line()
        geom, rc = self._dense_geom(), RasterConfig(chunk=512)
        structure = self._dense_shapes()
        per_fwd = sum(structure.values())
        samples = self._dense_samples(3, 20)
        model = self._dense_model().eval()

        def decode(s, marks=None):
            surfels = model(s["points"], s["feats"], s["mask"])
            if marks is not None:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return render_surfels(surfels, geom, rc)

        seen, hooks = self._dense_hooks(model)
        reset_counts()
        with torch.inference_mode():
            decode(samples[0])
        torch.cuda.synchronize()
        first = read_counts()
        for hk in hooks:
            hk.remove()
        with torch.inference_mode():
            decode(samples[1])
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            for i in range(DECODE_CLOUDS):
                out = decode(samples[i % len(samples)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            split = collections.Counter()
            for i in range(3):
                marks = [time.perf_counter()]
                decode(samples[i], marks)
                torch.cuda.synchronize()
                split["ptv3"] += (marks[1] - marks[0]) / 3
                split["raster"] += (time.perf_counter() - marks[1]) / 3
            fill = [[(int(m.sum()), m.shape[0]) for _, m, _ in
                     model.backbone.pooled_levels(s["points"], s["mask"])] for s in samples]
        want = {**{k: 0 for k in counters()}, "flash_attention": DECODE_CLOUDS * per_fwd}
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        log(f"dense decode ({DENSE_POINTS} points, 32x1024, RasterConfig chunk 512, f32, "
            f"{DECODE_CLOUDS} clouds): {DECODE_CLOUDS / wall:.3f} clouds/s; split per cloud "
            f"(synchronised): PT-v3 and surfel heads {split['ptv3']:.4f} s, raster "
            f"{split['raster']:.4f} s; peak memory {mem:.2f} GiB; launches {got} (structure: "
            f"{per_fwd} K1 a decode, {dict(sorted(structure.items()))}; hooks "
            f"{dict(sorted(seen['flash_attention'].items()))}; first decode {first}); "
            f"finite={finite}, pred_range {tuple(out['pred_range'].shape)}; valid rows against "
            f"capacity at levels 0-4 by cloud {fill}; card {card}")
        if (got != want or seen["flash_attention"] != structure
                or first != {**want, "flash_attention": per_fwd}):
            raise AssertionError(f"dense decode: launches {got} (first {first}, hooks {seen}) "
                                 f"differ from the structure {structure}")
        if not finite or tuple(out["pred_range"].shape) != tuple(geom.size):
            raise AssertionError("dense decode: non-finite or misshapen renders")
        self.dense_launches = got
        del model, out
        gc.collect()
        torch.cuda.empty_cache()

        # training: the CLI, then its step
        tmp = self.tmp_dir("dense_")
        t0 = time.perf_counter()
        trainer = TD.main(["--synthetic", "--steps", "2", "--workdir", os.path.join(tmp, "run")])
        model, state, step = trainer.state.model, trainer.state, trainer.step_fn
        dev = next(model.parameters()).device
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "ckpt")))
        log(f"dense: train_dense_decoder --synthetic --steps 2 in {time.perf_counter() - t0:.1f} "
            f"s on {dev}; checkpoints {ckpts}")
        if trainer.global_step != 2 or dev.type != "cuda" or len(ckpts) != 2:
            raise AssertionError("dense: the CLI did not train 2 steps on the card")
        seen, hooks = self._dense_hooks(model)
        reset_counts()
        state, _ = step(state, samples[0], None)
        torch.cuda.synchronize()
        first = read_counts()
        for hk in hooks:
            hk.remove()
        step(state, samples[1], None)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        losses = []
        for i in range(TRAIN_STEPS):
            state, logs = step(state, samples[i % len(samples)], None)
            losses.append(logs["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        timed = TD.make_dense_train_step(model, geom, rc, timed=True)
        phases = collections.Counter()
        for i in range(3):
            state, tl = timed(state, samples[i], None)
            for k in ("ptv3", "raster", "backward", "opt"):
                phases[k] += tl[f"seconds_{k}"] / 3
        per_step = {k: v / TRAIN_STEPS for k, v in got.items()}
        want = {**{k: 0.0 for k in counters()}, "flash_attention": float(per_fwd),
                "flash_attention_bwd": float(per_fwd)}
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        log(f"dense train step ({DENSE_POINTS} points, 32x1024, RasterConfig chunk 512, f32, "
            f"{TRAIN_STEPS} steps): {TRAIN_STEPS / wall:.3f} steps/s; phases per step "
            f"(synchronised): PT-v3 and surfel heads {phases['ptv3']:.4f} s, raster "
            f"{phases['raster']:.4f} s, loss+backward {phases['backward']:.4f} s, clip+AdamW "
            f"{phases['opt']:.4f} s; peak memory {mem:.2f} GiB; launches per step {per_step} "
            f"(hooks {dict(seen['flash_attention'])} forward, "
            f"{sum(seen['flash_attention_bwd'].values())} backward; first step {first}); last "
            f"loss {float(losses[-1]):.5f} finite={finite}; card {card}")
        if per_step != want or {k: float(v) for k, v in first.items()} != want \
                or seen["flash_attention"] != structure \
                or seen["flash_attention_bwd"] != structure or not finite:
            raise AssertionError(f"dense train: launches per step {per_step} (first {first}) "
                                 f"!= {want}, or a loss is not finite")
        self.dense_train_launches = got
        del trainer, model, state, step, timed
        gc.collect()
        # overfit: one fixed cloud, fresh weights, lr 1e-4 as the other
        # overfit checks (at the YAML's 2e-3, with no warm-up, the decoder
        # collapses within a few steps in both packages: _dense_yaml_lr);
        # the loss jumps where surfels change visibility, so the last five
        # steps' mean is held below step 0's
        model = self._dense_model()
        state = TD.create_dense_state(model, OVERFIT_LR, load_yaml(DENSE_YAML)["optimizer"]
                                      ["weight_decay"])
        step = TD.make_dense_train_step(model, geom, rc)
        curve = []
        for i in range(DENSE_OVERFIT_STEPS + 1):
            state, logs = step(state, samples[0], None)
            curve.append(float(logs["loss"]))
        tail = float(np.mean(curve[-5:]))
        log(f"dense overfit ({DENSE_OVERFIT_STEPS} steps at lr {OVERFIT_LR:g} on one cloud): loss "
            f"step 0 {curve[0]:.5f} -> mean of the last five {tail:.5f}, ratio "
            f"{tail / curve[0]:.4f}; curve {[round(c_, 5) for c_ in curve]}")
        if not tail < curve[0]:
            raise AssertionError("dense: gs_loss on a fixed cloud did not fall")
        del model, state, step
        self._dense_yaml_lr(geom, rc, samples[0])
        del samples
        gc.collect()
        torch.cuda.empty_cache()

        # the Gaussian range AE
        # its phase split on one synchronised step (4 s a step)
        self.gaus_ae_train_launches, self.gaus_ae_shapes = self._ae_train_run(
            "gaus AE train", GAUS_AE_YAML, accumulate=2, overfit=False, steps=GAUS_STEPS,
            split_steps=1)
        run = os.path.join(tmp, "gaus")
        t0 = time.perf_counter()
        trainer = TL.main(["-b", GAUS_AE_YAML, "--synthetic", "--steps", "1", "--workdir", run])
        dev = next(trainer.state.model.parameters()).device
        log(f"dense: train_lidm -b {os.path.relpath(GAUS_AE_YAML, HERE)} --synthetic --steps 1 "
            f"in {time.perf_counter() - t0:.1f} s on {dev}; run files {sorted(os.listdir(run))}")
        if trainer.global_step != 1 or dev.type != "cuda":
            raise AssertionError("dense: train_lidm did not train the Gaussian AE on the card")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ conditioning
    def _cond_shapes(self):
        """Kernel calls by shape, from module hooks on the full-width
        map2lidar model (f32): one U-Net eval at batch 2 and 4 (K1 in the 16
        SelfAttentionBlocks, whose norms are K3 besides the ResBlocks' and
        norm_out's; a SpatialTransformer U-Net runs K1 at the same shapes in
        its attn1 and has the same ResBlocks, and its GroupNorm is plain),
        one VQ decode at batch 2 and 4 (K3), and the classifier's loss and
        guidance_grad at its default config over 4 latents (K3 forward and
        backward); the U-Net evals of a DDIM-25 request."""
        if self.cond_shapes is None:
            import torch
            from lidar_layout_tpu_torch import sample_cond
            from lidar_layout_tpu_torch.models import classifier as CL
            from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
            from lidar_layout_tpu_torch.nn.blocks import Normalize
            from torch_port_helpers import count_group_norms

            model = sample_cond.build_task_model("map2lidar", device="cuda")
            shapes = {"evals": unet_evals(model, COND_STEPS)}
            lh, lw, lc = model.cfg.latent_shape
            attn_norms = {id(m.norm) for m in model.unet.modules()
                          if isinstance(m, SelfAttentionBlock)}
            for b in (2, 4):
                seen = {k: collections.Counter() for k in ("k1", "unet", "attn_norm", "dec")}
                where = {"now": "unet"}

                def norm_hook(mod, args, seen=seen, where=where):
                    bb, c, h, w = args[0].shape
                    key = (bb, c, h, w, mod.num_groups, mod.act)
                    seen[where["now"]][key] += 1
                    if id(mod) in attn_norms:
                        seen["attn_norm"][key] += 1

                def attn_hook(mod, args, seen=seen):
                    bb, c, h, w = args[0].shape
                    seen["k1"][(bb, mod.num_heads, h * w, c // mod.num_heads)] += 1

                hooks = [m.register_forward_pre_hook(attn_hook) for m in model.unet.modules()
                         if isinstance(m, SelfAttentionBlock)]
                hooks += [m.register_forward_pre_hook(norm_hook)
                          for m in list(model.unet.modules())
                          + list(model.first_stage_model.decoder.modules())
                          if isinstance(m, Normalize)]
                with torch.inference_mode():
                    z = torch.randn((b, lh, lw, lc), device="cuda")
                    cond = {"c_concat": torch.zeros((b, lh, lw, sample_cond.NUM_SEM),
                                                    device="cuda")}
                    model.apply_model(z, torch.full((b,), 500, device="cuda"), cond)
                    where["now"] = "dec"
                    model.decode_first_stage(z)
                for hk in hooks:
                    hk.remove()
                shapes[b] = seen
            del model
            clf = CL.NoisyLatentClassifier(CL.ClassifierConfig()).cuda()
            z0 = torch.randn((4, 16, 128, 8), device="cuda")
            labels = torch.arange(4, device="cuda") % clf.cfg.num_classes
            with count_group_norms(clf) as clf_calls:
                clf.loss(z0, labels, torch.Generator(device="cuda").manual_seed(0))[0].backward()
                clf.guidance_grad(z0, torch.full((4,), 300, device="cuda"), labels)
            shapes["clf"] = clf_calls
            del clf
            gc.collect()
            torch.cuda.empty_cache()
            self.cond_shapes = shapes
            for b in (2, 4):
                log(f"cond: batch {b}, per U-Net eval K1 {dict(shapes[b]['k1'])}, K3 "
                    f"{sum(shapes[b]['unet'].values())} ({sum(shapes[b]['attn_norm'].values())} "
                    f"in the SelfAttentionBlocks); per decode K3 {sum(shapes[b]['dec'].values())}")
            log(f"cond: classifier K3 forward {sum(clf_calls[0].values())}, backward "
                f"{sum(clf_calls[1].values())} over a loss step and a guidance_grad; U-Net evals "
                f"of DDIM-{COND_STEPS}: {shapes['evals']}")
        return self.cond_shapes

    def _kernels_cond(self):
        """K1 in f32 at the conditional U-Net's attention shapes (batch 2
        and 4: text2lidar's request and, under guidance, map2lidar's and
        cam2lidar's) against its plain version and bit for bit over two
        launches; K3 forward in f32 at every group shape of those U-Net
        evals and decodes, and forward and backward at the classifier's."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G

        shapes = self._cond_shapes()
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(14)
        attn = sorted(set(shapes[2]["k1"]) | set(shapes[4]["k1"]))
        log(f"K1 in f32 at the conditional U-Net's shapes {attn}:")
        for (b, h, s, d) in attn:
            q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev) for _ in range(3))
            got = A.flash_attention(q, k, v)
            self._check_cond("flash_attention", got, A._attend_ref(q, k, v), 2e-5, 1e-4,
                             f"{(b, h, s, d)} f32 (cond)")
            again = A.flash_attention(q, k, v)
            torch.cuda.synchronize()
            log(f"  {(b, h, s, d)} f32: two launches bit for bit equal: {torch.equal(got, again)}")
            if not torch.equal(got, again):
                raise AssertionError(f"K1 is not deterministic at {(b, h, s, d)} f32")
        fwd = set()
        for b in (2, 4):
            fwd |= set(shapes[b]["unet"]) | set(shapes[b]["dec"])
        clf_fwd, clf_bwd = shapes["clf"]
        fwd = {k[:6] for k in fwd} | {k[:6] for k in clf_fwd}
        log(f"K3 in f32 at the conditional path's {len(fwd)} group shapes (forward) and the "
            f"classifier's {len(clf_bwd)} (backward):")
        for (b, c, hh, ww, groups, act) in sorted(fwd):
            x = torch.randn((b, c, hh, ww), generator=gen, device=dev) * 2 + 0.3
            gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
            beta = 0.1 * torch.randn(c, generator=gen, device=dev)
            what = (f"{(b, c, hh, ww)} G={groups} act={act} f32 (cond; path "
                    f"{path_name(G.kernel_path(torch.float32, c, hh * ww, groups))})")
            self._check_cond("group_norm", G.group_norm(x, gamma, beta, groups, 1e-6, act),
                             G._ref(x, gamma, beta, groups, 1e-6, act), 1e-4, 1e-5, what)
        for (b, c, hh, ww, groups, act, eps) in sorted(clf_bwd):
            x = torch.randn((b, c, hh, ww), generator=gen, device=dev) * 2 + 0.3
            gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
            beta = 0.1 * torch.randn(c, generator=gen, device=dev)
            dy = torch.randn(x.shape, generator=gen, device=dev)
            got = G.group_norm_bwd(x, gamma, beta, dy, groups, eps, act)
            want = G._group_norm_bwd_ref(x, gamma, beta, dy, groups, eps, act)
            for part, g_, w_, t_ in zip(("dx", "dgamma", "dbeta"), got, want,
                                        ((1e-4, 1e-4), (1e-3, 1e-4), (1e-3, 1e-4))):
                self._check_cond("group_norm_bwd", g_, w_, *t_,
                                 f"{part} {(b, c, hh, ww)} G={groups} act={act} f32 (classifier)")
        torch.cuda.empty_cache()

    def _check_cond(self, name, got, want, atol, rtol, what):
        self._check(name, got, want, atol, rtol, what, record=False)
        key = f"cond_{name}"
        self.kernel_err[key] = max(self.kernel_err.get(key, 0.0), max_err(got, want)[0])

    @staticmethod
    def _cond_small(key):
        """A small LatentDiffusion under ``key`` (U-Net 64 wide, two levels,
        head dim 32, SpatialTransformers for the cross-attention keys, labels
        for adm; no first stage), seeded weights, and its example
        conditioning at batch 2 (numpy)."""
        from lidar_layout_tpu_torch.models.diffusion import DiffusionConfig, LatentDiffusion
        from lidar_layout_tpu_torch.models.unet import UNetConfig

        rng = np.random.default_rng(21)
        concat = rng.standard_normal((2, 8, 32, 3)).astype(np.float32)
        ctx = rng.standard_normal((2, 3, 24)).astype(np.float32)
        kw = dict(in_channels=8 + 3 * (key in ("concat", "hybrid")), model_channels=64,
                  out_channels=8, num_res_blocks=1, attention_resolutions=(1, 2),
                  channel_mult=(1, 2), num_head_channels=32)
        if key in ("crossattn", "hybrid"):
            kw.update(use_spatial_transformer=True, context_dim=24)
        if key == "adm":
            kw.update(num_classes=5)
        cond = {"concat": concat, "crossattn": ctx, "adm": np.array([1, 4]),
                "hybrid": {"c_concat": concat, "c_crossattn": ctx}}[key]
        model = LatentDiffusion(DiffusionConfig(conditioning_key=key, latent_shape=(8, 32, 8)),
                                UNetConfig(**kw))
        return seed_weights(model, 22).eval(), cond

    def cond_slice(self):
        """Card against CPU on the same numpy inputs, f32, TF32 off, at small
        widths: a SpatialTransformer with a context mask, the three
        conditioning stages (SpatialRescaler at map2lidar's full size, the
        multi-view CLIP image and text wrappers over 2-layer towers 64 wide),
        one U-Net eval (apply_model) under each of concat, crossattn, hybrid
        and adm, and the classifier's loss and guidance_grad at its default
        config over 4 latents; each within COND_SLICE_TOL relative L2."""
        import copy

        import torch
        from lidar_layout_tpu_torch.encoders import modules as E
        from lidar_layout_tpu_torch.models import classifier as CL
        from lidar_layout_tpu_torch.nn.attention import SpatialTransformer

        rng = np.random.default_rng(20)

        def to(x, dev):
            if isinstance(x, dict):
                return {k: to(v, dev) for k, v in x.items()}
            t = torch.from_numpy(np.asarray(x)).to(dev)
            return t.long() if t.dtype in (torch.int32, torch.int64) else t

        def both(name, module, fn, *inputs):
            outs = {}
            for dev in ("cpu", "cuda"):
                m = copy.deepcopy(module).to(dev).eval()
                with torch.no_grad():
                    outs[dev] = fn(m, *(to(x, dev) for x in inputs))
            got, want = outs["cuda"].float().cpu(), outs["cpu"].float()
            rel = float((got - want).norm() / want.norm())
            ok = rel <= COND_SLICE_TOL and bool(torch.isfinite(got).all())
            log(f"cond_slice {name}: {tuple(got.shape)} relative L2 {rel:.3e} (tol "
                f"{COND_SLICE_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cond_slice: {name} on the card disagrees with the CPU")

        st = seed_weights(SpatialTransformer(128, 4, 32, depth=1, context_dim=24), 23)
        x = rng.standard_normal((2, 128, 8, 32)).astype(np.float32)
        ctx = rng.standard_normal((2, 3, 24)).astype(np.float32)
        both("SpatialTransformer (128 wide, 4 heads of 32, masked context)", st,
             lambda m, a, c, k: m(a, c, k), x, ctx, np.array([[True, False, True]] * 2))
        sem = np.eye(19, dtype=np.float32)[rng.integers(0, 19, (2, 64, 1024))]
        both("SpatialRescaler (map2lidar's: 64x1024x19 -> 16x128x19)",
             seed_weights(E.SpatialRescaler(1, out_channels=19, wh_factors=(0.25, 0.125)), 24),
             lambda m, a: m(a), sem)
        img = seed_weights(E.FrozenClipMultiImageEmbedder(512, tower=E.ImageTransformerEncoder(
            28, 14, 64, 2, 4, 48)), 25)
        both("FrozenClipMultiImageEmbedder (2-layer tower, 64 wide)", img, lambda m, a: m(a),
             rng.standard_normal((2, 2, 28, 28, 3)).astype(np.float32))
        txt = seed_weights(E.FrozenClipMultiTextEmbedder(2, tower=E.TextTransformerEncoder(
            width=64, layers=2, heads=4)), 26)
        both("FrozenClipMultiTextEmbedder (2-layer tower, 64 wide)", txt, lambda m, a: m(a),
             E.simple_tokenize(["a busy intersection with cars", ""]))
        z = rng.standard_normal((2, 8, 32, 8)).astype(np.float32)
        for key in ("concat", "crossattn", "hybrid", "adm"):
            model, cond = self._cond_small(key)
            both(f"apply_model, conditioning_key {key}", model,
                 lambda m, a, t, c: m.apply_model(a, t, c), z, np.array([10, 700]), cond)
        clf = seed_weights(CL.NoisyLatentClassifier(CL.ClassifierConfig()), 27)
        z0 = rng.standard_normal((4, 16, 128, 8)).astype(np.float32)
        t = np.array([3, 250, 600, 1000])
        noise = rng.standard_normal(z0.shape).astype(np.float32)
        labels = np.array([0, 3, 7, 9])
        both("classifier loss (default config, 4 latents)", clf,
             lambda m, a, tt, n, y: m.loss(a, y, t=tt, noise=n)[0][None], z0, t, noise, labels)
        both("classifier guidance_grad", clf, lambda m, a, tt, y: m.guidance_grad(a, tt, y),
             z0, t, labels)
        gc.collect()
        torch.cuda.empty_cache()

    def cond(self):
        """The three CLIs at full width on the card, f32: sample_cond
        --task map2lidar and --task cam2lidar (4 samples, DDIM-25) and
        text2lidar at --cfg-scale 2.0 (2 samples, the doubled batch), each
        through its main(): the .npy of the JAX script's name and shape,
        finite, with ray-drop pixels; K1 and K3 launches against the
        model's structure (and map2lidar's against module hooks), no other
        kernel; peak memory; the conditioning stage's milliseconds a
        request. Then, with the U-Net and the first stage seeded
        (_seed_cond), one more request each, timed (seconds a
        request, samples/s): map2lidar and cam2lidar again with the
        conditions rolled over the batch, which must move the images;
        text2lidar at cfg_scale 1.0 too, which must differ from 2.0."""
        import torch
        from lidar_layout_tpu_torch import sample_cond, text2lidar
        from lidar_layout_tpu_torch.encoders.modules import simple_tokenize
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.attention import SpatialTransformer
        from lidar_layout_tpu_torch.nn.blocks import Normalize

        card = card_line()
        hooked = self._cond_shapes()
        total = collections.Counter()
        for task, n in (("map2lidar", 4), ("cam2lidar", 4), ("text2lidar", 2)):
            outdir = self.tmp_dir(f"cond_{task}_")
            argv = ["--outdir", outdir, "--steps", str(COND_STEPS)]
            if task == "text2lidar":
                main, key = text2lidar.main, "c_crossattn"
                argv += ["--cfg-scale", str(COND_CFG_SCALE)]
            else:
                main = sample_cond.main
                key = "c_concat" if task == "map2lidar" else "c_crossattn"
                argv += ["--task", task]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            model = out["model"]
            imgs = np.load(os.path.join(outdir, f"{task}_samples.npy"))
            n_attn = sum(isinstance(m, (SelfAttentionBlock, SpatialTransformer))
                         for m in model.unet.modules())
            unet_norms = sum(isinstance(m, Normalize) for m in model.unet.modules())
            dec_norms = sum(isinstance(m, Normalize)
                            for m in model.first_stage_model.decoder.modules())
            evals = unet_evals(model, COND_STEPS)
            want = {k: 0 for k in counters()}
            want.update(flash_attention=evals * n_attn,
                        group_norm=evals * unet_norms + dec_norms)
            drop = float((imgs == -1.0).mean())
            n_params = sum(p.numel() for p in model.parameters()) / 1e6
            log(f"cond {task} (main(), {n} samples, DDIM-{COND_STEPS}, f32"
                f"{f', cfg_scale {COND_CFG_SCALE:g}' if task == 'text2lidar' else ''}; "
                f"{n_params:.1f} M parameters): {os.path.basename(outdir)}/{task}_samples.npy "
                f"{imgs.shape} finite={bool(np.isfinite(imgs).all())} ray-drop share "
                f"{drop:.4f}; request {out['seconds']:.3f} s (main() {wall:.1f} s with the "
                f"build); peak memory {mem:.2f} GiB; launches {got}, structure {want} "
                f"({n_attn} attention blocks and {unet_norms} K3 norms a U-Net eval, {evals} "
                f"evals, {dec_norms} decoder norms): K1 {got['flash_attention'] / evals:g} and "
                f"K3 {(got['group_norm'] - dec_norms) / evals:g} a U-Net eval; card {card}")
            if imgs.shape != (n, 64, 1024, 1) or not np.isfinite(imgs).all() \
                    or not np.array_equal(imgs, out["samples"]) or not 0 < drop < 1:
                raise AssertionError(f"cond {task}: bad output")
            if got != want:
                raise AssertionError(f"cond {task}: launches {got} != structure {want}")
            if task == "map2lidar":
                per_request = {"flash_attention": evals * sum(hooked[n]["k1"].values()),
                               "group_norm": evals * sum(hooked[n]["unet"].values())
                               + sum(hooked[n]["dec"].values())}
                if per_request != {k: got[k] for k in per_request}:
                    raise AssertionError(f"cond: launches {got} != module hooks {per_request}")
            total.update(got)
            # the timed requests, and the conditioning moves the images
            self._seed_cond(model)
            if task == "text2lidar":
                tokens = np.tile(simple_tokenize(["a busy intersection with cars"]), (n, 1))
                runs = {f"cfg {s:g}": (tokens, s) for s in (COND_CFG_SCALE, 1.0)}
                uncond = simple_tokenize([""] * n)
            else:
                cond_in = sample_cond.synthetic_conditions(task, n)
                runs = {"conditions": (cond_in, 1.0),
                        "rolled": (np.roll(cond_in, 1, axis=0), 1.0)}
                uncond = None
            c_in = next(iter(runs.values()))[0]
            with torch.inference_mode():
                model.get_learned_conditioning(c_in)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.get_learned_conditioning(c_in)
                torch.cuda.synchronize()
            log(f"cond {task}: the conditioning stage ({type(model.cond_stage_model).__name__}) "
                f"takes {1e3 * (time.perf_counter() - t0):.2f} ms a request ({n} samples)")
            res = {}
            for name, (c_in, scale) in runs.items():
                torch.cuda.reset_peak_memory_stats()
                imgs2, sec = sample_cond.sample(model, key, c_in, n, COND_STEPS,
                                                uncond_in=uncond, cfg_scale=scale)
                res[name] = imgs2
                log(f"cond {task} seeded, {name}: {sec:.3f} s a request, {n / sec:.3f} "
                    f"samples/s, peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, finite="
                    f"{bool(np.isfinite(imgs2).all())}, ray-drop share "
                    f"{float((imgs2 == -1.0).mean()):.4f}")
                if not np.isfinite(imgs2).all():
                    raise AssertionError(f"cond {task}: non-finite images on seeded weights")
            a, b2 = res.values()
            moved = float(np.abs(a - b2).mean())
            log(f"cond {task} seeded: mean |difference| between the two requests {moved:.4e}")
            if moved == 0.0:
                raise AssertionError(f"cond {task}: the conditioning does not reach the images")
            del out, model
            gc.collect()
            torch.cuda.empty_cache()
        self.cond_launches = dict(total)

    @staticmethod
    def _seed_cond(model):
        """Seeded weights for a CLI model's U-Net, whose output torch's
        initialisation zeroes, and its first stage, whose ray-drop mask
        barely moves with the latent at torch's initialisation; the CLIP
        tower keeps its random initial weights."""
        seed_weights(model.unet, 0)
        seed_weights(model.first_stage_model, 1)

    def _timing_cond(self, gen):
        """K1 and K3 in f32 at the conditional path's shapes, summed over
        one map2lidar and one cam2lidar request (4 samples, DDIM-50): K1 at
        the 16 attention shapes of each U-Net eval (the SelfAttentionBlocks,
        the SpatialTransformers' attn1) beside SDPA; K3 at the U-Net's group
        shapes (map2lidar's attention norms included, cam2lidar's
        SpatialTransformer norms plain) and the decode's, beside F.group_norm
        + F.silu."""
        import torch

        shapes = self._cond_shapes()
        s4, evals = shapes[4], shapes["evals"]
        log(f"  conditional path, K1 in f32 (per map2lidar + cam2lidar request pair, "
            f"{evals} U-Net evals each):")
        k1 = self._time_k1(gen, {k: 2 * evals * c for k, c in s4["k1"].items()}, 1, " (cond)",
                           dtype=torch.float32)
        counts = collections.Counter()
        for key, c in s4["unet"].items():
            counts[key] += evals * (2 * c - s4["attn_norm"][key])
        for key, c in s4["dec"].items():
            counts[key] += 2 * c
        log("  conditional path, K3 in f32:")
        k3 = collections.Counter()
        for key, count in sorted(counts.items()):
            for name, val in self._time_k3(gen, key, f"x{count}/request pair (cond)",
                                           dtype=torch.float32).items():
                k3[name] += count * val
        for name, tot in (("flash_attention", k1), ("group_norm", k3)):
            self.run_totals.setdefault(name, {})["cond"] = tot
            log(f"  {name} over a map2lidar and a cam2lidar request (sum over shapes of "
                f"launches x time): kernel {tot['ms']:.3f} ms | plain {tot['plain_ms']:.3f} | "
                f"library {tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | "
                f"bound {tot['bound_ms']:.3f}")

    # ---------------------------------------------- R2DM, object AE, KL AE
    @staticmethod
    def _family_model(yaml_path, overrides=(), device="cuda", seed=0):
        """A YAML's model (with dotlist ``overrides``) at full width, built
        under ``seed`` as train_lidm builds it, and the config."""
        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config

        cfg = yaml_config(yaml_path, overrides)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = instantiate_from_config(cfg["model"]).to(device)
        return model, cfg

    @staticmethod
    def _family_batches(target, n, batch, device="cuda", seed=6, **params):
        """``n`` synthetic batches of a factory target (its YAML's dataset block)."""
        from lidar_layout_tpu_torch.config import load_yaml
        from lidar_layout_tpu_torch.data import factory as PF

        yaml_path = {"nusc_r2dm": R2DM_YAML, "nusc_object": G2SD_YAML}[target]
        dset = load_yaml(yaml_path)["data"]["params"]["dataset"]
        it = PF.build_batches(target, {"split": "train", **params}, dset, None, batch, seed,
                              force_synthetic=True, device=device)
        return [next(it) for _ in range(n)]

    def _r2dm_shapes(self):
        """K3's (forward, backward) calls of one full-width R2DM training step
        at batch 4 by shape, from module hooks: the forward's are one U-Net
        eval's, so a request's too."""
        if self.r2dm_shapes is None:
            import torch
            from torch_port_helpers import count_group_norms

            model, _ = self._family_model(R2DM_YAML)
            x = self._family_batches("nusc_r2dm", 1, R2DM_BATCH)[0]["image"]
            with count_group_norms(model) as shapes:
                model.p_losses(x, torch.Generator(device="cuda").manual_seed(0))[0].backward()
            torch.cuda.synchronize()
            self.r2dm_shapes = shapes
            log(f"r2dm: K3 per training step at batch {R2DM_BATCH}: forward "
                f"{sum(shapes[0].values())} over {len(shapes[0])} shapes, backward "
                f"{sum(shapes[1].values())}")
            del model, x
            gc.collect()
            torch.cuda.empty_cache()
        return self.r2dm_shapes

    def _kernels_families(self):
        """K3 forward and backward in f32 at every group shape of one R2DM
        training step at batch 4 (a request's U-Net eval has the forward's),
        both bit for bit over two launches. The KL AE's encoder, decoder and
        discriminator, and ReconTester's kitti AE, have the kitti VQ AE's
        group shapes, which _kernels_ae holds."""
        self._kernels_ae(self._r2dm_shapes(), "r2dm", f"R2DM's training step (batch "
                         f"{R2DM_BATCH}; widths 64-1024, up to 768 KB spans)", forward_twice=True)

    def families_slice(self):
        """The last families card against CPU on the same inputs and
        weights, f32, TF32 off, at small widths (R2DM 16 wide at 32x256, its
        U-Net four levels of one block): an R2DM U-Net eval for each
        coordinate encoding; p_losses with fed t and noise; one R2DM step
        (loss, gradients, parameters and EMA after AdamW); the object AE's
        loss and gradients and one step (4 objects of 512 points, 64
        folded); knn_query's indices on a lattice cloud full of ties, equal;
        one KL-AE step (16 wide, 32x256, fed posterior noise). Outputs and
        losses within FAMILIES_SLICE_TOL relative L2, gradients within
        FAMILIES_GRAD_TOL; after the update the parameters and EMA within
        2 lr and at most 1e-3 of the live parameters (gradient above 1e-6
        of its largest) off by more than 0.01 lr, as the other training
        slices."""
        import copy

        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config
        from lidar_layout_tpu_torch.models import r2dm as PR
        from lidar_layout_tpu_torch.models.object_ae import ObjectAEConfig, VQModelObject
        from lidar_layout_tpu_torch.ops.pointops import knn_query
        from lidar_layout_tpu_torch.train import family_trainer as FT

        rng = np.random.default_rng(30)

        def rel(got, want):
            got, want = got.detach().double().cpu(), want.detach().double().cpu()
            return float((got - want).norm() / want.norm().clamp_min(1e-30))

        def gate(name, got, want, tol=FAMILIES_SLICE_TOL):
            r = rel(got, want)
            ok = r <= tol and bool(torch.isfinite(got.detach().cpu()).all())
            log(f"families_slice {name}: {tuple(got.shape)} relative L2 {r:.3e} (tol {tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"families_slice: {name} on the card disagrees with the CPU")

        def r2dm(encoding):
            return seed_weights(PR.R2DMDiffusion(PR.R2DMConfig(
                image_size=(32, 256), base_channels=16, num_res_blocks=1,
                coords_encoding=encoding)), 31)

        x = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 256, 2)).astype(np.float32))
        t = torch.tensor([3, 700])
        for enc in (None, "fourier_features", "spherical_harmonics", "polar_coordinates"):
            model = r2dm(enc)
            outs = {}
            for dev in ("cpu", "cuda"):
                with torch.no_grad():
                    outs[dev] = copy.deepcopy(model).to(dev).eval().apply_model(x.to(dev),
                                                                                t.to(dev))
            gate(f"R2DM U-Net eval, coords_encoding {enc}", outs["cuda"], outs["cpu"])
        noise = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

        def stepped(name, model, cfg, batch, lr=1e-3, **kw):
            """One family step on each device from the same weights: the
            loss, the gradients the optimizer(s) took, and the trained
            parameters and (where there is one) the EMA after it."""
            res = {}
            for dev in ("cpu", "cuda"):
                m = copy.deepcopy(model).to(dev)
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(0)
                    state, step, _, _ = FT.family_training(m, cfg, lr)
                if hasattr(state, "disc"):
                    state.disc.load_state_dict(self._slice_disc.state_dict())
                opts = ([state.opt_g, state.opt_d] if hasattr(state, "opt_g")
                        else [state.optimizer])
                grads = [[] for _ in opts]
                for opt, taken in zip(opts, grads):
                    real = opt.step

                    def spy(gs=None, real=real, opt=opt, taken=taken):
                        g = gs if gs is not None else [
                            p.grad if p.grad is not None else torch.zeros_like(p)
                            for p in opt.params]
                        taken.extend(t_.detach().flatten() for t_ in g)
                        return real(gs) if gs is not None else real()
                    opt.step = spy
                b = {k: v.to(dev) for k, v in batch.items()}
                state, logs = step(state, b, None, **{k: v.to(dev) for k, v in kw.items()})
                # gradients and parameters in one order: the optimizers', each's
                after = torch.cat([p.detach().flatten() for opt in opts for p in opt.params])
                ema = (torch.cat([v.flatten() for v in state.ema.params.values()])
                       if hasattr(state, "ema") else None)
                res[dev] = (logs, torch.cat([g for taken in grads for g in taken]), after, ema)
            (lg, gg, ag, eg), (lw, gw, aw, ew) = res["cuda"], res["cpu"]
            for k in sorted(lw):
                if k != "grad_norm":
                    gate(f"{name} {k}", lg[k].reshape(1), lw[k].reshape(1))
            gate(f"{name} gradients", gg, gw, FAMILIES_GRAD_TOL)
            # Adam's first update is about lr * sign(g): where g is zero but
            # for rounding (a bias or time embedding before a GroupNorm takes
            # out its group's mean) the devices step apart by up to 2 lr. So
            # the share off is counted over the live elements, as dense_slice
            # counts it, and the EMA is held to its maximum
            diff = (ag.cpu() - aw).abs()
            live = gw.abs() > 1e-6 * gw.abs().max()
            off_all = float((diff > 0.01 * lr).float().mean())
            off = float((diff[live] > 0.01 * lr).float().mean())
            eerr = float((eg.cpu() - ew).abs().max()) if ew is not None else 0.0
            ok = float(diff.max()) <= 2 * lr and off <= 1e-3 and eerr <= 2 * lr
            log(f"families_slice {name} after the update: parameters' largest difference "
                f"{float(diff.max()):.3e} (tol 2 lr = {2 * lr:g}), share of live elements "
                f"off by more than 0.01 lr {off:.2e} (tol 1e-3; of all elements {off_all:.2e}, "
                f"{1 - float(live.float().mean()):.2e} not live), relative L2 "
                f"{rel(ag, aw):.3e}; EMA's largest difference "
                + (f"{eerr:.3e} (tol 2 lr)" if ew is not None else "- (no EMA)")
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"families_slice: {name}'s update on the card disagrees")

        model = r2dm("fourier_features")
        with torch.no_grad():
            losses = {dev: copy.deepcopy(model).to(dev).p_losses(
                x.to(dev), t=t.to(dev), noise=noise.to(dev))[0].reshape(1)
                for dev in ("cpu", "cuda")}
        gate("R2DM p_losses (fed t and noise)", losses["cuda"], losses["cpu"])
        stepped("R2DM step", model, {}, {"image": x}, t=t, noise=noise)

        obj = seed_weights(VQModelObject(ObjectAEConfig(num_points=512, num_grids=64)), 32)
        pts = torch.from_numpy(rng.uniform(-1, 1, (4, 512, 3)).astype(np.float32))
        with torch.no_grad():
            outs = {dev: copy.deepcopy(obj).to(dev)(pts.to(dev))[0] for dev in ("cpu", "cuda")}
        gate("object AE reconstruction", outs["cuda"], outs["cpu"])
        stepped("object AE step", obj, {}, {"fg_points": pts})

        lattice = torch.from_numpy(rng.integers(-4, 5, (2, 512, 3)).astype(np.float32))
        idx = {dev: knn_query(lattice.to(dev), lattice.to(dev), 17)[0].cpu()
               for dev in ("cpu", "cuda")}
        d = knn_query(lattice, lattice, 17)[1]
        ties = float((d[..., 1:] == d[..., :-1]).float().mean())
        log(f"families_slice knn_query on a lattice cloud (2 x 512 points, k 17; {ties:.2%} of "
            f"neighbour pairs tied): indices equal {torch.equal(idx['cuda'], idx['cpu'])}")
        if not torch.equal(idx["cuda"], idx["cpu"]):
            raise AssertionError("families_slice: knn_query's indices differ on the card")

        from lidar_layout_tpu_torch.losses.discriminator import LiDARNLayerDiscriminator

        kl_cfg = {"target": "autoencoder_kl", "params": {"embed_dim": 8, "ddconfig": {
            "ch": 16, "ch_mult": [1, 2, 2, 4], "strides": [[1, 2], [2, 2], [2, 2]],
            "num_res_blocks": 1, "z_channels": 8, "double_z": True}}}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(33)
            kl = instantiate_from_config(kl_cfg)
            self._slice_disc = LiDARNLayerDiscriminator(1)
        img = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 256, 1)).astype(np.float32))
        z_noise = torch.from_numpy(rng.standard_normal((2, 8, 8, 32)).astype(np.float32))
        stepped("KL AE step", kl, kl_cfg, {"image": img}, noise=z_noise)
        del self._slice_disc
        gc.collect()
        torch.cuda.empty_cache()

    def _family_run(self, name, step, state, batches, structure, hooked_modules, steps,
                    batch_size, loss_key, extra_hooked=None):
        """A family's timed steps: a warm-up under module hooks, another,
        then ``steps`` steps; steps/s, samples/s, peak memory, launches a
        step against ``structure`` (and the hooks: K3's here, and the
        attention calls that ``extra_hooked`` counts, read after the
        warm-up), no plain GroupNorm. Returns the launches over the timed
        steps."""
        import torch
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from torch_port_helpers import count_group_norms

        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts()
        with count_group_norms(*hooked_modules) as shapes:
            state, _ = step(state, batches[0], gen)
            torch.cuda.synchronize()
        first = read_counts()
        hooked = {**{k: 0 for k in counters()}, "group_norm": sum(shapes[0].values()),
                  "group_norm_bwd": sum(shapes[1].values()), **dict(extra_hooked or {})}
        step(state, batches[1 % len(batches)], gen)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        plain, real = collections.Counter(), (G._ref, G._group_norm_bwd_ref)

        def counting(n_, fn):
            def wrapped(*a, **k):
                plain[n_] += 1
                return fn(*a, **k)
            return wrapped
        G._ref, G._group_norm_bwd_ref = (counting("_ref", real[0]),
                                         counting("_group_norm_bwd_ref", real[1]))
        try:
            t0 = time.perf_counter()
            losses = []
            for i in range(steps):
                state, logs = step(state, batches[i % len(batches)], gen)
                losses.append(logs[loss_key])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            G._ref, G._group_norm_bwd_ref = real
        got = read_counts()
        per_step = {k: v / steps for k, v in got.items()}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        log(f"{name} (batch {batch_size}, f32, TF32 off, {steps} steps): {steps / wall:.3f} "
            f"steps/s, {steps * batch_size / wall:.2f} samples/s, {1e3 * wall / steps:.2f} ms a "
            f"step; peak memory {mem:.2f} GiB; launches per step {per_step} (structure "
            f"{structure}; hooks {hooked}; first step {first}); plain GroupNorm calls "
            f"{dict(plain)}; last {loss_key} {float(losses[-1]):.5f} finite={finite}; card "
            f"{card_line()}")
        if (per_step != {k: float(v) for k, v in structure.items()} or first != structure
                or hooked != structure):
            raise AssertionError(f"{name}: launches per step {per_step} (first {first}, hooks "
                                 f"{hooked}) != structure {structure}")
        if sum(plain.values()) or not finite:
            raise AssertionError(f"{name}: plain GroupNorm ran {dict(plain)}, or a loss is "
                                 f"not finite")
        return got

    @staticmethod
    def _overfit(name, step, state, batch, loss_key, **kw):
        """OVERFIT_STEPS steps on one fixed batch at OVERFIT_LR (``state``
        built at that rate): ``loss_key`` must fall."""
        gen = None
        curve = []
        for _ in range(OVERFIT_STEPS + 1):
            state, logs = step(state, batch, gen, **kw)
            curve.append(float(logs[loss_key]))
        log(f"{name} overfit ({OVERFIT_STEPS} steps at lr {OVERFIT_LR:g} on one batch): "
            f"{loss_key} step 0 {curve[0]:.5f} -> step {OVERFIT_STEPS} {curve[-1]:.5f}, ratio "
            f"{curve[-1] / curve[0]:.4f}; curve {[round(c_, 5) for c_ in curve[::5]]}")
        if not curve[-1] < curve[0]:
            raise AssertionError(f"{name}: {loss_key} on a fixed batch did not fall")

    def _family_cli(self, name, yaml_path, overrides=()):
        """train_lidm -b <yaml> --synthetic --steps 1 on the card (one step
        for the smoke's time; R2DM's checkpoint is 1.1 GB): the trainer."""
        import shutil

        import torch
        from lidar_layout_tpu_torch.train import train_lidm as TL

        run = os.path.join(self.tmp_dir(f"{name}_"), "run")
        t0 = time.perf_counter()
        trainer = TL.main(["-b", yaml_path, "--synthetic", "--steps", "1", "--workdir", run,
                           *overrides])
        dev = next(trainer.state.model.parameters()).device
        lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
        val = {k: v for k, v in lines[-1].items() if k.startswith("val/")}
        log(f"{name}: train_lidm -b {os.path.relpath(yaml_path, HERE)} {' '.join(overrides)} "
            f"--synthetic --steps 1 in {time.perf_counter() - t0:.1f} s on {dev}; validation "
            f"{val}; run files {sorted(os.listdir(run))}")
        if trainer.global_step != 1 or dev.type != "cuda" or not val or not all(
                np.isfinite(v) for v in val.values()):
            raise AssertionError(f"{name}: the CLI did not train a step on the card")
        shutil.rmtree(run)   # R2DM's checkpoints are 1.1 GB each
        torch.cuda.empty_cache()
        return trainer

    def families(self):
        """The last families at full width on the card, f32, TF32 off:
        r2dm_diffusion.yaml through train_lidm, R2DM_STEPS timed steps at batch 4
        (61 + 61 K3 launches a step against the structure and hooks), an
        overfit check on one batch with fixed t and noise, then, on seeded
        weights, two DDIM-50 requests of 4 samples and range2pcd on channel
        0 (samples/s, peak memory, 52 x 61 K3 launches a request);
        g2sd_32.yaml through train_lidm, FAMILY_STEPS timed steps at batch 4 on
        1024-point synthetic objects (no kernel), an overfit check; the KL
        override of the kitti AE's YAML through train_lidm, FAMILY_STEPS timed steps
        (K3 against the structure and hooks), an overfit check; run_tester
        with ReconTester on the kitti AE (ae_train's run when it ran)."""
        import torch
        from lidar_layout_tpu_torch import run_tester
        from lidar_layout_tpu_torch.models.samplers import ddim_sample
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.ops.lidar import range2pcd
        from lidar_layout_tpu_torch.pipeline import geometry_from_config
        from lidar_layout_tpu_torch.train import family_trainer as FT

        zero = {k: 0 for k in counters()}
        # ---- R2DM: training
        trainer = self._family_cli("r2dm", R2DM_YAML, ("data.params.num_val_batches=1",))
        model, state, step = trainer.state.model, trainer.state, trainer.step_fn
        n_norms = sum(isinstance(m, Normalize) for m in model.modules())
        batches = self._family_batches("nusc_r2dm", 3, R2DM_BATCH)
        structure = {**zero, "group_norm": n_norms, "group_norm_bwd": n_norms}
        self.families_launches["r2dm_train"] = self._family_run(
            "r2dm train", step, state, batches, structure, (model,), R2DM_STEPS, R2DM_BATCH,
            "loss")
        cfg = trainer.state.model.cfg
        del trainer, state
        gen = torch.Generator(device="cuda").manual_seed(7)
        t = torch.randint(0, cfg.timesteps, (R2DM_BATCH,), generator=gen, device="cuda")
        noise = torch.randn(batches[0]["image"].shape, generator=gen, device="cuda")
        state, step, _, _ = FT.family_training(model, {}, OVERFIT_LR)
        self._overfit("r2dm", step, state, batches[0], "loss", t=t, noise=noise)
        del state, step
        # ---- R2DM: serving on seeded weights, the output layer scaled so that
        # the noise estimate of a Gaussian image has unit std, as a trained one
        seed_weights(model, 8)
        model.eval()
        geom = geometry_from_config(yaml_config(R2DM_YAML))
        with torch.inference_mode():
            probe = model.apply_model(torch.randn((2, *geom.size, cfg.channels), generator=gen,
                                                  device="cuda"),
                                      torch.full((2,), cfg.timesteps // 2, device="cuda"))
        scale = float(probe.std())
        with torch.no_grad():
            model.unet.conv_out.weight.div_(scale)
            model.unet.conv_out.bias.div_(scale)
        log(f"r2dm: seeded weights; conv_out divided by {scale:.4g}, the std of the noise "
            f"estimate at t = {cfg.timesteps // 2}")
        evals = unet_evals(model, R2DM_DDIM)
        want = {**zero, "group_norm": evals * n_norms}
        total = collections.Counter()
        for r in range(R2DM_REQUESTS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                x = ddim_sample(model, (R2DM_SAMPLES, *geom.size, cfg.channels),
                                steps=R2DM_DDIM, generator=gen, device="cuda")
                xyz, valid = range2pcd(x[..., 0], geom)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = read_counts()
            total.update(got)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            finite = bool(torch.isfinite(x).all()) and bool(torch.isfinite(xyz).all())
            log(f"r2dm request {r} (DDIM-{R2DM_DDIM}, {R2DM_SAMPLES} samples "
                f"{tuple(x.shape)}, f32, seeded weights): {sec:.3f} s, "
                f"{R2DM_SAMPLES / sec:.3f} samples/s; peak memory {mem:.2f} GiB; range2pcd "
                f"{tuple(xyz.shape)}, {int(valid.sum())} valid points, finite={finite}; "
                f"depth channel mean {float(x[..., 0].mean()):.4f} std "
                f"{float(x[..., 0].std()):.4f}; launches {got} (structure {want}: {evals} "
                f"U-Net evals x {n_norms} norms); card {card_line()}")
            if got != want or not finite or tuple(xyz.shape) != (
                    R2DM_SAMPLES, geom.size[0] * geom.size[1], 3):
                raise AssertionError(f"r2dm request: launches {got} != {want}, or bad output")
        self.families_launches["r2dm_request"] = {k: v / R2DM_REQUESTS for k, v in total.items()}
        del model, x, xyz, valid, batches
        gc.collect()
        torch.cuda.empty_cache()
        # ---- the object AE
        trainer = self._family_cli("g2sd", G2SD_YAML)
        model, state, step = trainer.state.model, trainer.state, trainer.step_fn
        batches = self._family_batches("nusc_object", 3, 4)
        log(f"g2sd: objects {tuple(batches[0]['fg_points'].shape)}, reconstruction "
            f"{model.cfg.num_grids} points, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
            f" M parameters")
        self.families_launches["g2sd_train"] = self._family_run(
            "g2sd train", step, state, batches, zero, (model,), FAMILY_STEPS, 4, "rec_loss")
        del trainer, state
        state, step, _, _ = FT.family_training(model, {}, OVERFIT_LR)
        self._overfit("g2sd", step, state, batches[0], "rec_loss")
        del model, state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
        # ---- the KL autoencoder
        trainer = self._family_cli("kl", AE_YAML, KL_OVERRIDES)
        model, state, step = trainer.state.model, trainer.state, trainer.step_fn
        structure, n_ae, n_disc = self._ae_structure(model, state.disc)
        structure["group_norm_bwd"] = n_ae + 3 * n_disc   # no adaptive weight: 3 views, 3 passes
        batches = self._ae_batches(3)
        self.families_launches["kl_train"] = self._family_run(
            "kl train", step, state, batches, structure, (model, state.disc), FAMILY_STEPS,
            AE_BATCH, "rec_loss")
        cfg_model = yaml_config(AE_YAML, KL_OVERRIDES)["model"]
        del trainer, state
        state, step, _, _ = FT.family_training(model, cfg_model, OVERFIT_LR)
        self._overfit("kl", step, state, batches[0], "rec_loss")
        del model, state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
        # ---- run_tester with ReconTester on the kitti AE
        model, _ = self._family_model(AE_YAML)
        n_norms = sum(isinstance(m, Normalize) for m in model.modules())
        del model
        argv = ["-b", AE_YAML, "--synthetic", "--n-batches", "4"]
        if self.ae_run is not None:
            argv += ["-r", self.ae_run]
        reset_counts()
        t0 = time.perf_counter()
        out = run_tester.main(argv)
        torch.cuda.synchronize()
        got = read_counts()
        want = {**zero, "group_norm": 4 * n_norms}
        log(f"run_tester {' '.join(os.path.relpath(a, HERE) if os.sep in a else a for a in argv)}"
            f": {out} in {time.perf_counter() - t0:.1f} s; launches {got} (structure {want})")
        if got != want or not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"run_tester: launches {got} != {want}, or a meter is not finite")
        self.families_launches["recon_tester"] = got
        gc.collect()
        torch.cuda.empty_cache()

    def _timing_families(self, gen):
        """K3 in f32 at R2DM's shapes: the forward at each shape of a U-Net
        eval at batch 4, summed over a DDIM-50 request (52 evals) and over
        the R2DM_STEPS timed training steps, and the backward over those steps,
        each beside F.group_norm + F.silu (and its autograd backward) and
        the bound."""
        import torch

        fwd, bwd = self._r2dm_shapes()
        evals = R2DM_DDIM + 2
        req, train, train_bwd = (collections.Counter() for _ in range(3))
        log(f"  R2DM, K3 forward in f32 (per U-Net eval at batch {R2DM_BATCH}):")
        for (b, c, hh, ww, groups, act, eps), count in sorted(fwd.items()):
            t = self._time_k3(gen, (b, c, hh, ww, groups, act),
                              f"x{count}/eval (r2dm)", dtype=torch.float32, eps=eps)
            for k, v in t.items():
                req[k] += count * v * evals
                train[k] += count * v * R2DM_STEPS
        log("  R2DM, K3 backward in f32 (per training step):")
        for (b, c, hh, ww, groups, act, eps), count in sorted(bwd.items()):
            t = self._time_k3_bwd(gen, (b, c, hh, ww, groups, act),
                                  f"x{count}/step (r2dm)", dtype=torch.float32, eps=eps)
            for k, v in t.items():
                train_bwd[k] += count * v * R2DM_STEPS
        for name, run, tot in (("group_norm", f"a DDIM-{R2DM_DDIM} request", req),
                               ("group_norm", f"{R2DM_STEPS} training steps", train),
                               ("group_norm_bwd", f"{R2DM_STEPS} training steps", train_bwd)):
            log(f"  {name} over R2DM's {run} (sum over shapes of launches x time): kernel "
                f"{tot['ms']:.3f} ms (events {tot['events_ms']:.3f}) | plain {tot['plain_ms']:.3f}"
                f" | library {tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | "
                f"bound {tot['bound_ms']:.3f} (kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}%"
                f" of it)")
        self.run_totals.setdefault("group_norm", {}).update(r2dm_request=req, r2dm_train=train)
        self.run_totals.setdefault("group_norm_bwd", {})["r2dm_train"] = train_bwd
        torch.cuda.empty_cache()

    # -------------------------------------------------- the point-backbone zoo
    @staticmethod
    def _zoo_model(name, tiny, device="cuda", seed=0, **over):
        """A zoo backbone (``ZOO_TINY`` or ``ZOO_REFERENCE``, ``over``
        replacing config fields) built under ``seed``, and its cloud spec."""
        import importlib

        import torch

        module, cls, cfg_cls, kw, cloud = (ZOO_TINY if tiny else ZOO_REFERENCE)[name]
        mod = importlib.import_module(f"lidar_layout_tpu_torch.models.{module}")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = getattr(mod, cls)(getattr(mod, cfg_cls)(**{**kw, **over}))
        return model.to(device), cloud

    @staticmethod
    def _zoo_cloud(n, valid, in_ch, extent, seed=0, device="cuda"):
        """(coord, feat, mask) of one cloud: ``extent`` None draws N(0, 1)
        points, a number U(0, extent) ones, "scene" a synthetic street scene
        (``data/synthetic``); feats [xyz, U(-1, 1)...] cut to ``in_ch``; the
        rows past ``valid`` are padding."""
        import torch
        from lidar_layout_tpu_torch.data.synthetic import synthetic_scene

        rng = np.random.default_rng(seed)
        coord = (synthetic_scene(rng, n) if extent == "scene" else
                 rng.normal(size=(n, 3)) if extent is None else
                 rng.uniform(0.0, extent, (n, 3))).astype(np.float32)
        feat = np.concatenate([coord, rng.uniform(-1, 1, (n, max(in_ch - 3, 0)))], -1)[:, :in_ch]
        mask = np.arange(n) < valid
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (coord, feat.astype(np.float32), mask))

    def zoo_slice(self):
        """The zoo card against CPU at the CPU tests' tiny configs, f32, TF32
        off: each segmentation backbone's logits and every parameter's
        gradient of a seeded weighted sum of them, Sonata's loss, center and
        student gradients from fed seeds (relative L2 within ZOO_SLICE_TOL),
        and cluster_points' labels (equal)."""
        import copy

        import torch
        from lidar_layout_tpu_torch.models import ptv3 as P3
        from lidar_layout_tpu_torch.models import sonata as PS
        from lidar_layout_tpu_torch.ops import cluster as PC

        def rel(got, want):
            got, want = got.detach().double().cpu(), want.detach().double().cpu()
            return float((got - want).norm() / want.norm().clamp_min(1e-30))

        def flat_grads(model):
            return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                              .reshape(-1).cpu() for _, p in sorted(model.named_parameters())])

        reset_counts()
        for name in ZOO_TINY:
            cpu, cloud = self._zoo_model(name, True, device="cpu")
            card = copy.deepcopy(cpu).cuda()
            inputs = self._zoo_cloud(**cloud, device="cpu")
            w = torch.randn((len(inputs[0]), cpu.cfg.num_classes),
                            generator=torch.Generator().manual_seed(5))
            outs = []
            for model, dev in ((cpu, "cpu"), (card, "cuda")):
                out = model(*(t.to(dev) for t in inputs))
                (out * w.to(dev)).sum().backward()
                outs.append(out)
            torch.cuda.synchronize()
            pad = float(outs[1].detach()[~inputs[2].cuda()].abs().max())
            errs = (rel(outs[1], outs[0]), rel(flat_grads(card), flat_grads(cpu)))
            log(f"zoo_slice {name}: logits {errs[0]:.3e}, parameter gradients {errs[1]:.3e} "
                f"relative L2 card vs CPU (tol {ZOO_SLICE_TOL:g}); padding rows max |logit| "
                f"{pad:g}")
            if not (max(errs) <= ZOO_SLICE_TOL and pad == 0.0
                    and bool(torch.isfinite(outs[1]).all())):
                raise AssertionError(f"zoo_slice {name}: card against CPU {errs}, padding {pad}")
        self._zoo_no_kernel("zoo_slice")
        # Sonata (PT-v3: K1 and K2): the CPU test's config, the loss from fixed seeds
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            cpu = PS.Sonata(P3.PTv3Config(**SONATA_TINY_BB), PS.SonataConfig(**SONATA_TINY))
        card = copy.deepcopy(cpu).cuda()
        coord, feat, mask = self._zoo_cloud(128, 110, 4, 6.0, device="cpu")
        seeds = torch.randperm(128, generator=torch.Generator().manual_seed(7))[:32]
        res = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            loss, center, masked = model.loss(coord.to(dev), feat.to(dev), mask.to(dev), 2,
                                              seed_idx=seeds.to(dev))
            loss.backward()
            res.append((loss, center, masked, flat_grads(model.student)))
        torch.cuda.synchronize()
        errs = (rel(res[1][0], res[0][0]), rel(res[1][1], res[0][1]), rel(res[1][3], res[0][3]))
        same_mask = torch.equal(res[1][2].cpu(), res[0][2])
        log(f"zoo_slice sonata: loss {errs[0]:.3e}, center {errs[1]:.3e}, student gradients "
            f"{errs[2]:.3e} relative L2 card vs CPU; ball masks equal: {same_mask}")
        if not (max(errs) <= ZOO_SLICE_TOL and same_mask):
            raise AssertionError(f"zoo_slice sonata: card against CPU {errs}, {same_mask}")
        pts, _, valid = self._zoo_cloud(2000, 1900, 3, 12.0, device="cpu")
        want = PC.cluster_points(pts, valid, 0.3, 4096)
        got = PC.cluster_points(pts.cuda(), valid.cuda(), 0.3, 4096)
        same = all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want))
        log(f"zoo_slice cluster_points (2000 points, 0.3 m, 4096 voxels): labels card vs CPU "
            f"equal: {same}; {len(torch.unique(want[0][valid]))} components")
        if not same:
            raise AssertionError("cluster_points: card labels differ from the CPU's")

    @staticmethod
    def _zoo_no_kernel(what):
        counts = read_counts()
        if any(counts.values()):
            raise AssertionError(f"{what}: the zoo launched a TPU kernel's port {counts}")

    def zoo(self):
        """The six segmentation backbones at their reference widths on one
        synthetic street scene of ZOO_POINTS rows (ZOO_PAD of them padding),
        f32: one forward and one backward of a cross-entropy over seeded
        labels; finite logits and gradients, padding rows 0, seconds, peak
        memory, and no kernel launched (none of these reaches a Pallas
        kernel in JAX)."""
        import torch
        import torch.nn.functional as F

        reset_counts()
        for name, (_, _, _, kw, cloud) in ZOO_REFERENCE.items():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model, cloud = self._zoo_model(name, False)
            coord, feat, mask = self._zoo_cloud(**cloud)
            labels = torch.randint(0, model.cfg.num_classes, (len(coord),),
                                   generator=torch.Generator(device="cuda").manual_seed(3),
                                   device="cuda")
            n_params = sum(p.numel() for p in model.parameters())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(coord, feat, mask)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            F.cross_entropy(logits[mask], labels[mask]).backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            grads_ok = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                           if p.grad is not None)
            pad = float(logits.detach()[~mask].abs().max())
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"zoo {name} ({n_params / 1e6:.2f} M parameters; {cloud['n']} rows, "
                f"{cloud['valid']} valid; {ZOO_NOTES.get(name, 'the ctor defaults')}): forward "
                f"{t1 - t0:.3f} s, backward {t2 - t1:.3f} s; peak memory {mem:.2f} GiB; logits "
                f"finite {bool(torch.isfinite(logits).all())}, padding rows max |logit| {pad:g},"
                f" gradients finite {grads_ok}; card {card_line()}")
            if not (bool(torch.isfinite(logits).all()) and pad == 0.0 and grads_ok):
                raise AssertionError(f"zoo {name}: logits or gradients not finite, or padding "
                                     f"rows not 0")
            del model, coord, feat, mask, labels, logits
        self._zoo_no_kernel("zoo")

    # ------------------------------------------------ Sonata pre-training
    @staticmethod
    def _ptv3_shapes(cfg, points):
        """K1's (B, H, S, D) calls of one PT-v3 forward over ``points`` rows:
        level l holds points / 2**l rows and attends in patches of
        min(patch_size, rows) (B patches, H heads, D = width / H); each
        encoder and decoder block attends once."""
        out = collections.Counter()
        for depths, widths, heads in ((cfg.enc_depths, cfg.enc_channels, cfg.enc_heads),
                                      (cfg.dec_depths, cfg.dec_channels, cfg.dec_heads)):
            for level, (depth, ch, h) in enumerate(zip(depths, widths, heads)):
                rows = max(points >> level, 1)
                patch = min(cfg.patch_size, rows)
                out[(-(-rows // patch), h, patch, ch // h)] += depth
        return out

    def _sonata_model(self, device="cuda"):
        import torch
        from lidar_layout_tpu_torch.models import ptv3 as P3
        from lidar_layout_tpu_torch.models import sonata as PS

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return PS.Sonata(P3.PTv3Config(), PS.SonataConfig(**SONATA_REFERENCE)).to(device)

    def sonata(self):
        """Sonata's pre-training step at PT-v3's default widths (enc 32-512,
        patch 1024, head dim 16) with the reference head (4096 hidden, 512
        embed, 4096 prototypes) on one synthetic scene of SONATA_POINTS rows,
        f32: K1 and K2 at its attention shapes against their plain versions
        (with a ragged key-padding tail and a patch of padding alone), then
        2 warm-up and SONATA_STEPS timed steps of make_pretrain_step with
        AdamW: steps/s, peak memory, K1 and K2 launches a step against the
        structure (two forwards, one backward) and hooks, a finite loss, the
        teacher and the center moving."""
        import torch
        from lidar_layout_tpu_torch.models.ptv3 import PTv3Config

        shapes = self._ptv3_shapes(PTv3Config(), SONATA_POINTS)
        self._kernels_ptv3_attention(shapes, "sonata", "Sonata's PT-v3", 17)
        model = self._sonata_model()
        opt = torch.optim.AdamW(model.student.parameters(), lr=SONATA_LR, weight_decay=0.04)
        step = model.make_pretrain_step(opt)
        coord, feat, mask = self._zoo_cloud(SONATA_POINTS, SONATA_POINTS - ZOO_PAD, 4, "scene")
        gen = torch.Generator(device="cuda").manual_seed(0)
        seen, hooks = self._dense_hooks(model)
        reset_counts()
        step(coord, feat, mask, 0, gen)
        torch.cuda.synchronize()
        first = read_counts()
        for h_ in hooks:
            h_.remove()
        hooked = {**{k: 0 for k in counters()}, **{k: sum(v.values()) for k, v in seen.items()}}
        structure = {**{k: 0 for k in counters()},
                     "flash_attention": 2 * sum(shapes.values()),
                     "flash_attention_bwd": sum(shapes.values())}
        step(coord, feat, mask, 1, gen)
        teacher0 = [p.detach().clone() for p in model.teacher.parameters()]
        center0 = model.center.clone()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        losses = [step(coord, feat, mask, 2 + i, gen) for i in range(SONATA_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        self.sonata_launches = got
        per_step = {k: v / SONATA_STEPS for k, v in got.items()}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        moved = max(float((p - q).abs().max()) for p, q in zip(model.teacher.parameters(),
                                                               teacher0))
        center_moved = float((model.center - center0).abs().max())
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        log(f"sonata ({SONATA_POINTS} rows, {ZOO_PAD} padding; {SONATA_STEPS} steps): "
            f"{SONATA_STEPS / wall:.3f} steps/s, {1e3 * wall / SONATA_STEPS:.1f} ms a step; peak "
            f"memory {mem:.2f} GiB; launches per step {per_step} (structure {structure}; hooks "
            f"{hooked}; first step {first}); losses {[round(float(x), 5) for x in losses]}; "
            f"the teacher moved by up to {moved:.3e}, the center by {center_moved:.3e}; card "
            f"{card_line()}")
        if (per_step != {k: float(v) for k, v in structure.items()} or first != structure
                or hooked != structure):
            raise AssertionError(f"sonata: launches {per_step} (first {first}, hooks {hooked}) "
                                 f"!= structure {structure}")
        if not (finite and moved > 0 and center_moved > 0):
            raise AssertionError("sonata: a loss is not finite, or the teacher or the center "
                                 "did not move")
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()

    # -------------------------------------- conditional LiDM training
    @staticmethod
    def _bert_lidm(device="cuda"):
        """The flagship LiDM (uncond_c2_p4.yaml's widths) made conditional as
        JAX's _lidm_cfg in tests/test_xt_consumer.py wires it: crossattn
        through SpatialTransformers (context 640) from a trainable
        x-transformers BERT at its defaults (640 wide, 32 layers, 8 heads, 77
        tokens); seeded weights (torch's initialisation zeroes the
        transformers' output projections, and with them the BERT's gradient)."""
        import torch
        from lidar_layout_tpu_torch.config import instantiate_from_config

        cfg = yaml_config(LIDM_YAML)["model"]
        p = cfg["params"]
        p.update(conditioning_key="crossattn", cond_stage_trainable=True,
                 cond_stage_config={"target": "bert_embedder",
                                    "params": {"backend": "x_transformer"}})
        p["unet_config"]["params"].update(use_spatial_transformer=True, transformer_depth=1,
                                          context_dim=640)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = instantiate_from_config(cfg).to(device)
        seed_weights(model.unet, 0)
        seed_weights(model.first_stage_model, 1)
        return model

    @staticmethod
    def _attention_modules(model):
        """The modules whose forward launches K1 (and K2 in a backward): the
        SpatialTransformers' attn1 and the SelfAttentionBlocks."""
        from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock
        from lidar_layout_tpu_torch.nn.attention import BasicTransformerBlock

        return ([m.attn1 for m in model.modules() if isinstance(m, BasicTransformerBlock)]
                + [m for m in model.modules() if isinstance(m, SelfAttentionBlock)])

    def _cond_train_shapes(self, key, model=None):
        """K1 calls of one training step of the ``key`` ("crossattn" or
        "concat") LiDM at batch COND_TRAIN_BATCH by (B, H, S, D), and K3's
        (forward, backward) calls by shape, from module hooks on one step of
        ``model`` (built here when not given); its gradients are cleared."""
        if key not in self.cond_train_shapes:
            import torch
            from torch_port_helpers import count_group_norms

            made = model is None
            model = self._cond_train_model(key) if made else model
            model.first_stage_model.requires_grad_(False)
            k1 = collections.Counter()

            def hook(mod, args):
                x = args[0]
                if x.dim() == 4:              # a SelfAttentionBlock's (B, C, H, W)
                    b, c, hh, ww = x.shape
                    k1[(b, mod.num_heads, hh * ww, c // mod.num_heads)] += 1
                else:
                    k1[(x.shape[0], mod.heads, x.shape[1], mod.dim_head)] += 1
            hooks = [m.register_forward_pre_hook(hook) for m in self._attention_modules(model)]
            batch = self._cond_train_batches(key, 1)[0]
            with count_group_norms(model) as k3:
                model.training_loss(batch, torch.Generator(device="cuda").manual_seed(0)
                                    )[0].backward()
            torch.cuda.synchronize()
            for h_ in hooks:
                h_.remove()
            model.zero_grad(set_to_none=True)
            self.cond_train_shapes[key] = {"k1": k1, "k3": k3}
            log(f"cond_train {key}: per step K1 {dict(k1)}, K3 forward {sum(k3[0].values())} "
                f"over {len(k3[0])} shapes, backward {sum(k3[1].values())}")
            if made:
                del model
                gc.collect()
                torch.cuda.empty_cache()
        return self.cond_train_shapes[key]

    def _cond_train_model(self, key):
        """The crossattn LiDM with its BERT, or map2lidar's model as
        sample_cond builds it (seeded weights)."""
        from lidar_layout_tpu_torch import sample_cond

        if key == "crossattn":
            return self._bert_lidm()
        model = sample_cond.build_task_model("map2lidar")
        self._seed_cond(model)
        return model

    @staticmethod
    def _cond_train_batches(key, n, seed=6):
        """Flagship range batches (64x1024, batch COND_TRAIN_BATCH) with their
        conditions: bert_tokenize's 77 tokens of seeded captions, or
        map2lidar's one-hot semantic maps."""
        import torch
        from lidar_layout_tpu_torch import sample_cond
        from lidar_layout_tpu_torch.encoders.modules import bert_tokenize

        batches = Smoke._train_batches(False, n, seed=seed, batch=COND_TRAIN_BATCH)
        rng = np.random.default_rng(seed)
        for b in batches:
            if key == "crossattn":
                words = rng.choice(COND_TRAIN_WORDS, (COND_TRAIN_BATCH, 6))
                b["cond"] = torch.from_numpy(bert_tokenize([" ".join(w) for w in words])).cuda()
            else:
                b["cond"] = torch.from_numpy(np.eye(sample_cond.NUM_SEM, dtype=np.float32)[
                    rng.integers(0, sample_cond.NUM_SEM, (COND_TRAIN_BATCH, 64, 1024))]).cuda()
        return batches

    def cond_train(self):
        """Conditional LiDM training on the card, f32, for the crossattn
        LiDM with the trainable BERT (2 warm-up and COND_TRAIN_STEPS timed
        steps) and map2lidar (c_concat, built as sample_cond builds it, its
        trained set JAX's: the U-Net; COND_CONCAT_STEPS timed steps). For
        each: K3 forward and backward at its training shapes against the
        plain versions, and for the crossattn model K2 in f32 at head dim 32
        at its three attention shapes (bit for bit over two launches); then
        steps/s, peak memory, K1, K2 and K3 launches a step against the
        structure and hooks, finite losses, the trained set and its EMA, and
        the BERT's gradients at the first step non-zero and finite."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(15)
        for key, steps in (("crossattn", COND_TRAIN_STEPS), ("concat", COND_CONCAT_STEPS)):
            model = self._cond_train_model(key)
            shapes = self._cond_train_shapes(key, model)
            if key == "crossattn":
                log(f"K2 in f32 at the crossattn U-Net's attention shapes "
                    f"{sorted(shapes['k1'])}:")
                for (b, h, s, d) in sorted(shapes["k1"]):
                    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                                   for _ in range(4))
                    o, lse = A._launch(q, k, v, None, with_lse=True)
                    grads = A.flash_attention_bwd(q, k, v, o, do, lse)
                    for part, g_, w_ in zip(("dq", "dk", "dv"), grads,
                                            A._attend_bwd_ref(q, k, v, o, do, lse)):
                        self._check("flash_attention_bwd", g_, w_, 1e-4, 1e-4,
                                    f"{part} {(b, h, s, d)} f32 (cond_train)", record=False)
                        err_key = "cond_train_flash_attention_bwd"
                        self.kernel_err[err_key] = max(self.kernel_err.get(err_key, 0.0),
                                                       max_err(g_, w_)[0])
                    again = A.flash_attention_bwd(q, k, v, o, do, lse)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a_, g_) for a_, g_ in zip(again, grads))
                    log(f"  {(b, h, s, d)} f32: two launches of K2 bit for bit equal: {same}")
                    if not same:
                        raise AssertionError(f"K2 is not deterministic at {(b, h, s, d)} f32")
                    del q, k, v, do, o, lse, grads, again
            self._kernels_ae(shapes["k3"], "cond_train",
                             f"the {key} LiDM's training step (batch {COND_TRAIN_BATCH})")
            params = DT.trainable_params(model)
            state = DT.create_train_state(model, DT.make_optimizer(params, COND_TRAIN_LR), params)
            keys = DT.trainable_keys(model)
            bert = [k for k in params if k.startswith("cond_stage_model.")]
            grads_seen = {}
            real = state.optimizer.step

            def spy(real=real, grads_seen=grads_seen, bert=bert, params=params):
                if not grads_seen:
                    grads_seen.update({k: params[k].grad for k in bert})
                    grads_seen["first"] = True
                return real()
            state.optimizer.step = spy
            k1 = sum(shapes["k1"].values())
            k3f, k3b = (sum(c.values()) for c in shapes["k3"])
            structure = {**{k: 0 for k in counters()}, "flash_attention": k1,
                         "flash_attention_bwd": k1, "group_norm": k3f, "group_norm_bwd": k3b}
            seen = collections.Counter()
            hooks = [m.register_forward_pre_hook(
                lambda mod, args, seen=seen: seen.update(["flash_attention",
                                                          "flash_attention_bwd"]))
                for m in self._attention_modules(model)]
            got = self._family_run(f"cond_train {key}", DT.make_train_step(model), state,
                                   self._cond_train_batches(key, 2), structure, [model], steps,
                                   COND_TRAIN_BATCH, "loss", extra_hooked=seen)
            for h_ in hooks:
                h_.remove()
            self.cond_train_launches[key] = got
            live = {k: float(g.norm()) for k, g in grads_seen.items()
                    if k != "first" and g is not None}
            ema_ok = set(state.ema.params) == set(params)
            log(f"cond_train {key}: trained set {keys} ({len(params)} tensors, {len(bert)} of "
                f"the BERT); EMA over the trained set: {ema_ok}; BERT gradients at the first "
                f"step: {len(live)} of {len(bert)} present, least norm "
                f"{min(live.values()) if live else 0:.3e}, all finite "
                f"{all(np.isfinite(v) for v in live.values())}")
            want_keys = ("unet", "cond_stage") if key == "crossattn" else ("unet",)
            bert_ok = (key != "crossattn"
                       or (bert and len(live) == len(bert) and min(live.values()) > 0
                           and all(np.isfinite(v) for v in live.values())))
            if keys != want_keys or not ema_ok or not bert_ok:
                raise AssertionError(f"cond_train {key}: trained set {keys}, EMA {ema_ok}, or "
                                     f"the BERT's gradients {live}")
            del model, state, params
            gc.collect()
            torch.cuda.empty_cache()

    def _timing_sonata(self, gen):
        """K1 and K2 in f32 with a key bias at Sonata's PT-v3 shapes, summed
        over its SONATA_STEPS timed steps (two forwards, one backward a step)."""
        from lidar_layout_tpu_torch.models.ptv3 import PTv3Config

        shapes = self._ptv3_shapes(PTv3Config(), SONATA_POINTS)
        fwd, bwd = self._time_attention(gen, shapes, 2 * SONATA_STEPS, SONATA_STEPS, True,
                                        "sonata", "step")
        self.run_totals.setdefault("flash_attention", {})["sonata"] = fwd
        self.run_totals.setdefault("flash_attention_bwd", {})["sonata"] = bwd

    def _timing_cond_train(self, gen):
        """K1 and K2 in f32 at the crossattn U-Net's attention shapes (head
        dim 32) beside SDPA's forward and backward, and K3 forward and
        backward at its group shapes, summed over its COND_TRAIN_STEPS timed
        steps."""
        shapes = self._cond_train_shapes("crossattn")
        fwd, bwd = self._time_attention(gen, shapes["k1"], COND_TRAIN_STEPS, COND_TRAIN_STEPS,
                                        False, "cond_train", "step")
        gn_f, gn_b = self._timing_ae(gen, shapes["k3"], "crossattn LiDM", COND_TRAIN_STEPS)
        for name, tot in (("flash_attention", fwd), ("flash_attention_bwd", bwd),
                          ("group_norm", gn_f), ("group_norm_bwd", gn_b)):
            self.run_totals.setdefault(name, {})["cond_train"] = tot

    def _time_attention(self, gen, shapes, fwd_runs, bwd_runs, kbias, label, unit):
        """K1 and K2 in f32 at each (B, H, S, D) of ``shapes`` (calls a
        forward) on PatchAttention's layout (views of one projection), with a
        zero key bias when ``kbias``: the kernel and SDPA (the bias as an
        additive float mask) in turns, the plain version, the bound
        (operations at the f32 rate or the bytes) and the SFU floor; K1
        summed over ``fwd_runs`` forwards, K2 over ``bwd_runs`` backwards.
        Returns (K1 totals, K2 totals)."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import attention as A

        dev = torch.device("cuda")
        tots = {"fwd": collections.Counter(), "bwd": collections.Counter()}
        log(f"  {label}, K1 and K2 at its attention shapes (f32"
            f"{', zero kbias' if kbias else ''}):")
        for (b, h, s, d), count in sorted(shapes.items()):
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = torch.randn((b, h, s, d), generator=gen, device=dev)
            kb = torch.zeros((b, s), device=dev) if kbias else None
            mask = kb[:, None, None, :] if kbias else None
            o, lse = A._launch(q, k, v, kb, with_lse=True)
            ql, kl, vl = (t_.detach().clone().requires_grad_() for t_ in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
            for part, runs, kern, lib, plain in (
                    ("fwd", fwd_runs, lambda: A.flash_attention(q, k, v, kb),
                     lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                     lambda: A._attend_ref(q, k, v, kb)),
                    ("bwd", bwd_runs, lambda: A.flash_attention_bwd(q, k, v, o, do, lse, kb),
                     lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
                     lambda: A._attend_bwd_ref(q, k, v, o, do, lse, kb))):
                cost = A.attention_cost(b, h, s, d, 4, backward=part == "bwd")
                nbytes = cost["bytes"] + (4 * b * s if kbias else 0)   # the bias row
                kms, lms, krounds, lrounds = paired_ms(kern, lib, 10)
                t = {"ms": kms, "events_ms": cuda_time(kern, 10),
                     "plain_ms": device_ms(plain, 3), "library_ms": lms}
                ops_ms, bytes_ms = cost["flops"] / PEAK_F32 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
                t["bound_ms"] = max(ops_ms, bytes_ms)
                t["sfu_ms"] = cost["transcendentals"] / sfu_ex2_per_ms()
                name = "K1" if part == "fwd" else "K2"
                bound_gate(f"{name} {(b, h, s, d)} f32 ({label})", t["bound_ms"], t["ms"])
                log(f"  {name} {(b, h, s, d)} f32 x{count}/{'forward' if part == 'fwd' else unit}"
                    f": kernel {t['ms']:.4f} (events {t['events_ms']:.4f}) | plain "
                    f"{t['plain_ms']:.4f} | sdpa{' backward' if part == 'bwd' else ''} "
                    f"{t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.3f}x) | bound "
                    f"{t['bound_ms']:.4f} ({'operations' if ops_ms >= bytes_ms else 'bytes'}; "
                    f"{cost['flops'] / 1e9:.2f} GFLOP at 67 TFLOP/s f32, {nbytes / 1e6:.1f} MB; "
                    f"kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of it) | SFU floor "
                    f"{t['sfu_ms']:.4f} (kernel at {100 * t['sfu_ms'] / t['ms']:.1f}% of it) | "
                    f"rounds kernel {[round(x, 4) for x in krounds]} library "
                    f"{[round(x, 4) for x in lrounds]}")
                for key, val in t.items():
                    tots[part][key] += count * val * runs
                    tots[part][f"one_{key}"] += count * val
                tots[part]["bound_ops_ms"] += count * ops_ms * runs
                tots[part]["bound_bytes_ms"] += count * bytes_ms * runs
            del qkv, q, k, v, do, o, lse, ql, kl, vl, out
        for part, runs in (("fwd", fwd_runs), ("bwd", bwd_runs)):
            tot = tots[part]
            log(f"  {label} {'K1' if part == 'fwd' else 'K2'} over {runs} "
                f"{'forwards' if part == 'fwd' else 'backwards'}: kernel {tot['ms']:.3f} ms | "
                f"plain {tot['plain_ms']:.3f} | library {tot['library_ms']:.3f} "
                f"({tot['ms'] / tot['library_ms']:.3f}x) | bound {tot['bound_ms']:.3f} | SFU "
                f"floor {tot['sfu_ms']:.3f}")
        torch.cuda.empty_cache()
        return tots["fwd"], tots["bwd"]

    # ---------------------------------------------------------------- ae_eval
    def ae_eval(self):
        """eval_ae on the ae_train phase's kitti run (trained here through
        the CLI for 2 steps when that phase did not run): -n 4 batches of
        the YAML's 4 synthetic KITTI-geometry scans reconstructed on the
        card, scored with CD (K4) and JSD; launches against the structure:
        K3 once a batch for every norm of the autoencoder, K4 twice a pair."""
        import torch
        from lidar_layout_tpu_torch import eval_ae as EA
        from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
        from lidar_layout_tpu_torch.nn.blocks import Normalize
        from lidar_layout_tpu_torch.train import train_lidm as TL

        if self.ae_run is None:
            self.ae_run = os.path.join(self.tmp_dir("ae_eval_"), "kitti")
            TL.main(["-b", AE_YAML, "--synthetic", "--steps", "2", "--workdir", self.ae_run])
            gc.collect()
            torch.cuda.empty_cache()
        cfg = load_yaml(AE_YAML)
        n_norms = sum(isinstance(m, Normalize)
                      for m in instantiate_from_config(cfg["model"]).modules())
        n_batches, batch = 4, cfg["data"]["params"]["batch_size"]
        want = {k: 0 for k in counters()}
        want.update(group_norm=n_batches * n_norms, chamfer_nn=2 * n_batches * batch)
        real = EA.reconstruction_clouds

        def keep(*a, **k):   # the clouds K4 sees, for the timing phase
            self.ae_eval_clouds = real(*a, **k)
            return self.ae_eval_clouds
        EA.reconstruction_clouds = keep
        reset_counts()
        t0 = time.perf_counter()
        try:
            res = EA.main(["-b", AE_YAML, "-r", self.ae_run, "-n", str(n_batches), "--metrics",
                           "cd", "jsd"])
        finally:
            EA.reconstruction_clouds = real
        wall = time.perf_counter() - t0
        got = read_counts()
        log(f"ae_eval: eval_ae -b {os.path.relpath(AE_YAML, HERE)} -r <the ae_train run> -n "
            f"{n_batches} --metrics cd jsd in {wall:.1f} s: {res}; launches {got}, structure "
            f"{want} ({n_norms} norms in the autoencoder, {n_batches * batch} pairs); card "
            f"{card_line()}")
        if got != want or sorted(res) != ["cd", "jsd"] or \
                not all(np.isfinite(v) and v >= 0 for v in res.values()):
            raise AssertionError(f"ae_eval: launches {got} != {want}, or bad scores {res}")
        self.ae_eval_launches = got

    def _timing_coarse(self, gen):
        """K1, K2 and K3 at the coarse paths' shapes: K1 and K3 forward
        summed over a coarse DPM-20 run (generate(32), batch 16), K2 and K3's
        backward over the coarse LiDM's TRAIN_STEPS timed training steps, K3 forward
        and backward in f32 over the coarse AE's TRAIN_STEPS timed steps."""
        shapes = self._coarse_shapes()
        log("  coarse LiDM, K1 at its request's shapes (bf16):")
        k1 = self._time_k1(gen, shapes["request"]["flash_attention"], N_MAIN // BATCH,
                           " (coarse)")
        log("  coarse LiDM, K3 at its request's shapes (bf16):")
        k3 = collections.Counter()
        for key, count in sorted(shapes["request"]["group_norm"].items()):
            for name, val in self._time_k3(gen, key, f"x{count}/request (coarse)").items():
                k3[name] += count * val * (N_MAIN // BATCH)
        k2 = self._timing_bwd(gen, shapes["train"]["flash_attention_bwd"],
                              "coarse LiDM training step")
        k3b = self._timing_gn_bwd(gen, shapes["train"], "coarse LiDM")
        ae_f, ae_b = self._timing_ae(gen, shapes["ae"], "coarse AE")
        for name, run, tot in (("flash_attention", "coarse", k1), ("group_norm", "coarse", k3),
                               ("flash_attention_bwd", "coarse_train", k2),
                               ("group_norm_bwd", "coarse_train", k3b),
                               ("group_norm", "coarse_ae_train", ae_f),
                               ("group_norm_bwd", "coarse_ae_train", ae_b)):
            self.run_totals.setdefault(name, {})[run] = tot
            log(f"  {name} over the {run} run (sum over shapes of launches x time): kernel "
                f"{tot['ms']:.3f} ms | plain {tot['plain_ms']:.3f} | library "
                f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | bound "
                f"{tot['bound_ms']:.3f}")

    def _timing_dense(self, gen):
        """The dense decoder's K1 and K2 in f32 with a key bias at each of
        its attention shapes (_time_attention), K1 summed over the dense
        phase's DECODE_CLOUDS decodes, K2 over its TRAIN_STEPS timed steps.
        The bias is zero: every level of the synthetic 8192-point clouds is
        full, so no padding reaches a key. Then K3 forward and backward in
        f32 at the Gaussian AE step's shapes, summed over its timed steps."""
        fwd, bwd = self._time_attention(gen, self._dense_shapes(), DECODE_CLOUDS, TRAIN_STEPS,
                                        True, "dense decoder", "step")
        self.run_totals.setdefault("flash_attention", {})["dense"] = fwd
        self.run_totals.setdefault("flash_attention_bwd", {})["dense_train"] = bwd
        ae_f, ae_b = self._timing_ae(gen, self._gaus_ae_shapes(), "Gaussian AE", GAUS_STEPS)
        self.run_totals.setdefault("group_norm", {})["gaus_ae_train"] = ae_f
        self.run_totals.setdefault("group_norm_bwd", {})["gaus_ae_train"] = ae_b

    # --------------------------------------------------------------------- ddp
    def ddp(self):
        """parallel/ on the card. (a) train_lidm at full width through NCCL at
        world = card count, ranks started as torchrun starts them: one copy
        of the run's files, rank 0's; the parameters after DDP_STEPS steps
        against a one-process train_lidm run; timed steps, launches a step
        against the structure, the all-reduce's time; one FSDP step against
        the plain step. (b) the rehearsal of two ranks on one card over gloo:
        one bf16 step at global batch 16 (8 a rank), replicas bit-equal,
        against the one-process batch-16 step; launches a rank; a dp-sharded
        DPM-20 generate(16) against the one-process one. The dry run
        (``parallel.dryrun``) runs in (a)'s ranks. With more than one card,
        K1-K4 on the last card while card 0 is current."""
        import torch

        card, n = card_line(), torch.cuda.device_count()
        self._ddp_nccl(card, n)
        self._ddp_gloo(card)
        self._ddp_dryrun(n)
        self._ddp_other_device(n)
        torch.backends.cudnn.deterministic = False

    def _ddp_dryrun(self, n):
        """The dry run that ran in (a)'s ranks (``dryrun_body``: the tiny
        flagship step on its dp x fsdp mesh, a falling trajectory, the cube,
        layout and dense families), held by ``check_dryrun``, and its
        gathered DDIM-8 against one process's within 2e-4."""
        import torch
        from lidar_layout_tpu_torch.flagship import flagship
        from lidar_layout_tpu_torch.models.samplers import ddim_sample
        from lidar_layout_tpu_torch.parallel.dryrun import check_dryrun
        from lidar_layout_tpu_torch.utils.init import jax_init_

        out = check_dryrun(self.ddp_dryrun)
        model, _ = flagship(tiny=True, device="cuda")
        jax_init_(model, 3)
        want = ddim_sample(model, (2 * n, *model.cfg.latent_shape), steps=8,
                           generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda").detach().float().cpu().numpy()
        err = float(np.abs(out["ddim"] - want).max())
        log(f"ddp dry run in (a)'s {n} rank(s) (NCCL): mesh {out['mesh']}, loss "
            f"{out['loss']:.4f}, trajectory {out['trajectory'][0]:.4f} -> "
            f"{out['trajectory'][-1]:.4f}, cube {out['cube_losses'][0]:.4f} -> "
            f"{out['cube_losses'][-1]:.4f}, layout overfit {out['layout_overfit'][0]:.4f} -> "
            f"{out['layout_overfit'][-1]:.4f}, dense losses {out['dense_losses']}; sharded "
            f"DDIM-8 against one process: max_abs_err {err:.3e} (tol 2e-4)")
        if err > 2e-4 * max(1.0, float(np.abs(want).max())):
            raise AssertionError("ddp: the dry run's sharded DDIM differs from one process's")

    def _ddp_nccl(self, card, n):
        import torch
        from lidar_layout_tpu_torch.parallel.dryrun import spawn
        from lidar_layout_tpu_torch.train import trainer as TR
        from lidar_layout_tpu_torch.train.train_lidm import main as train_lidm

        work = self.tmp_dir("ddp_nccl_")
        t0, started = time.perf_counter(), time.time()
        r = spawn(ddp_nccl_rank, n, (work,), device="cuda", env_store=True, timeout=900)[0]
        wall = time.perf_counter() - t0
        ends = r["entered"] - started, time.time() - r["left"]   # the ranks' start, exit
        files = sorted(os.path.relpath(os.path.join(d, f), work)
                       for d, _, fs in os.walk(work) for f in fs)
        last = f"step_{DDP_STEPS:08d}.pt"
        want_files = [f"ckpt/{last}", f"ckpt_best/{last}", "config.yaml", "metrics.jsonl"]
        # one checkpoint written: the best one is a link to it
        one_copy = files == want_files and os.path.samefile(
            os.path.join(work, "ckpt", last), os.path.join(work, "ckpt_best", last))
        inodes = {os.stat(os.path.join(d, f)).st_ino: os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(work) for f in fs}
        ckpt_gb = sum(inodes.values()) / 1e9
        # the one-process run of the same command, then its timed steps
        _ddp_exact()
        ref_work = self.tmp_dir("ddp_ref_")
        t_ref = time.perf_counter()
        real = TR.save_checkpoint, TR.link_checkpoint   # the reference's weights stay in memory
        TR.save_checkpoint = TR.link_checkpoint = lambda *a, **k: None
        try:
            ref = train_lidm(ddp_cli_args(ref_work))
        finally:
            TR.save_checkpoint, TR.link_checkpoint = real
        t_ref = time.perf_counter() - t_ref
        ckpt = torch.load(os.path.join(work, "ckpt", last), map_location="cuda",
                          weights_only=True)
        mine = ref.state.model.state_dict()
        n_tensors = len(ckpt["model"])
        unequal = [k for k, v in ckpt["model"].items() if not torch.equal(v, mine[k])]
        rel = max((float((ckpt["model"][k].float() - mine[k].float()).abs().max())
                   / max(float(mine[k].float().abs().max()), 1e-30) for k in unequal),
                  default=0.0)
        state, step, gen = ref.state, ref.step_fn, ref.generator
        batches = [next(ref.data_iter) for _ in range(DDP_TIMED)]
        state, _ = step(state, batches[0], gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in batches:
            state, _ = step(state, b, gen)
        torch.cuda.synchronize()
        plain = DDP_TIMED / (time.perf_counter() - t1)
        del ref, state, step, ckpt, mine
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        overhead_ms = 1e3 * (1 / r["steps_per_s"] - 1 / plain)
        log(f"ddp (a) NCCL: {r['world']} rank(s) of {n} card(s), backend {r['backend']}; "
            f"train_lidm {os.path.relpath(LIDM_YAML, HERE)} --synthetic --bf16, global batch "
            f"{DDP_BATCH}, {DDP_STEPS} steps in {r['cli_s']:.1f} s ({wall:.1f} s with the "
            f"ranks' start {ends[0]:.1f} s and exit {ends[1]:.1f} s, timed steps {r['timed_s']:.1f} s, FSDP {r['fsdp_s']:.1f} s, the dry "
            f"run {r['dryrun_s']:.1f} s; {ckpt_gb:.2f} GB written; the one-process run, its "
            f"checkpoints not written, {t_ref:.1f} s); files {files}, the best checkpoint a "
            f"link to the step's {one_copy}; "
            f"parameters after {DDP_STEPS} steps against the "
            f"one-process run: {len(unequal)} of {n_tensors} tensors differ "
            f"(largest relative {rel:.3e}); {DDP_TIMED} timed steps {r['steps_per_s']:.3f} "
            f"steps/s a rank against {plain:.3f} one-process ({overhead_ms:+.2f} ms a step), "
            f"all-reduce of the U-Net's gradients {r['all_reduce_ms']:.3f} ms "
            f"({r['all_reduce_ms'] * r['steps_per_s'] / 10:.2f}% of a step); peak "
            f"{r['peak_gib']:.2f} GiB a rank; launches a step {r['launches']} (structure "
            f"{r['structure']}); card {card}")
        log(f"ddp (a) FSDP at world {r['world']}: {r['fsdp_sharded']} of {r['fsdp_params']} "
            f"U-Net parameters sharded; loss {r['fsdp_loss']:.6f} (plain {r['plain_loss']:.6f}), "
            f"grad_norm {r['fsdp_norm']:.6f} (plain {r['plain_norm']:.6f}); parameters after "
            f"AdamW bit-equal {r['fsdp_bit_equal']}, largest difference "
            f"{r['fsdp_diff_lr']:.3f} lr, {r['fsdp_share_off']:.2e} off by 0.01 lr; launches "
            f"{r['fsdp_launches']} (plain {r['plain_launches']})")
        bad = []
        if r["backend"] != "nccl" or r["world"] != n:
            bad.append("not NCCL at world = card count")
        if not one_copy:
            bad.append(f"files {files} != {want_files}, the best a link to the step's")
        if unequal:
            bad.append(f"{len(unequal)} tensors differ from the one-process run")
        if r["launches"] != {k: float(v) for k, v in r["structure"].items()}:
            bad.append("launches a step differ from the structure")
        if r["fsdp_launches"] != r["structure"] or r["plain_launches"] != r["structure"]:
            bad.append("the FSDP step's launches differ from the structure")
        if not (r["fsdp_bit_equal"] or (r["fsdp_diff_lr"] <= 2.01
                                        and r["fsdp_share_off"] <= 1e-3)):
            bad.append("the FSDP step's parameters differ from the plain step's")
        if abs(r["fsdp_norm"] - r["plain_norm"]) > 1e-5 * r["plain_norm"]:
            bad.append("the FSDP step's gradient norm differs")
        if bad:
            raise AssertionError("ddp (a): " + "; ".join(bad))
        self.ddp_launches = {k: int(v * DDP_TIMED) for k, v in r["launches"].items()}
        self.ddp_dryrun = r["dryrun"]

    def _ddp_gloo(self, card):
        import torch
        from lidar_layout_tpu_torch.models import samplers as S
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
        from lidar_layout_tpu_torch.parallel.dryrun import spawn
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        ref_dir = self.tmp_dir("ddp_gloo_")
        _ddp_exact()
        t_ref = time.perf_counter()
        batch = self._train_batches(False, 1, seed=6, batch=DDP_BATCH)[0]
        seeded = seed_weights(ddp_flagship(), 0).state_dict()   # every model here starts so
        torch.save(seeded, os.path.join(ref_dir, "seeded.pt"))
        ref = {}
        for key in ("16", "halves"):   # one process at batch 16, and as two ranks of 8 do
            model = ddp_flagship(seeded)
            params = DT.trainable_params(model)
            state = DT.create_train_state(model, DT.make_optimizer(params, 1e-4), params)
            gen = torch.Generator(device="cuda").manual_seed(0)
            if key == "16":
                state, logs = DT.make_train_step(model, autocast_dtype=torch.bfloat16)(
                    state, batch, gen)
                ref[key] = (float(logs["loss"]), float(logs["grad_norm"]))
            else:
                ref[key] = _halves_step(model, state, batch, gen)
            torch.save({k: p.detach() for k, p in model.unet.named_parameters()},
                       os.path.join(ref_dir, f"unet_{key}.pt"))
            del model, state, params
        model = ddp_flagship(seeded, torch.bfloat16)
        del seeded
        want = GenerationPipeline(model, KITTI_GEOMETRY, sampler="dpm", steps=20).generate(
            DDP_BATCH, seed=0, batch=DDP_BATCH).images
        x_T = torch.randn((DDP_BATCH, *model.cfg.latent_shape), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
        with torch.inference_mode():   # the same noise in two batches of 8, as the ranks run it
            want8 = np.concatenate([model.decode_first_stage(S.dpm_solver_sample(
                model, x.shape, steps=20, x_T=x, device="cuda")).float().cpu().numpy()
                for x in x_T.split(DDP_BATCH // 2)])
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_ref
        t0, started = time.perf_counter(), time.time()
        ranks = spawn(ddp_gloo_rank, 2, (ref_dir,), device="cuda", backend="gloo", timeout=900)
        wall = time.perf_counter() - t0
        ends = (max(r["entered"] for r in ranks) - started,
                time.time() - min(r["left"] for r in ranks))
        torch.backends.cudnn.deterministic = False
        r0 = ranks[0]
        got = np.load(os.path.join(ref_dir, "dp_images.npy")).astype(np.float32)
        mask_g, mask_w = got[..., 0] > -1.0, want[..., 0] > -1.0   # ray-drop applied
        mask_agree = float((mask_g == mask_w).mean())
        both = mask_g & mask_w
        img_err = float(np.abs(got[..., 0] - want[..., 0])[both].max()) if both.any() else 0.0
        img_mean = float(np.abs(got[..., 0] - want[..., 0])[both].mean()) if both.any() else 0.0
        same8 = bool(np.array_equal(got, want8.astype(np.float32)))
        err8 = float(np.abs(got - want8).max())
        (loss16, norm16), (loss8, norm8) = ref["16"], ref["halves"]
        log(f"ddp (b) rehearsal: 2 ranks share one device over {r0['backend']} "
            f"({wall:.1f} s with the ranks' start {ends[0]:.1f} s and exit {ends[1]:.1f} s; one "
            f"process's steps and requests "
            f"{t_ref:.1f} s); bf16 step at global batch {DDP_BATCH} "
            f"(8 a rank): loss {r0['loss']:.6f} (one process at batch 16 {loss16:.6f}, as two "
            f"halves of 8 {loss8:.6f}), grad_norm {r0['grad_norm']:.6f} ({norm16:.6f}, "
            f"{norm8:.6f}); replicas bit-equal {[r['replicas_equal'] for r in ranks]}; the "
            f"U-Net after the step bit-equal to one process's halves "
            f"{r0['equal_halves']} (largest difference {r0['diff_lr_halves']:.3f} lr), "
            f"against one process's batch-16 step: largest difference "
            f"{r0['diff_lr_16']:.3f} lr, {r0['share_off_16']:.3e} of the elements off by "
            f"0.01 lr; launches a rank {[r['launches'] for r in ranks]} (structure "
            f"{r0['structure']}); train_lidm's set-up seeds each rank's default CUDA generator "
            f"apart (a draw differs across the ranks): {r0['dropout_draws_differ']}; "
            f"{DDP_TIMED_SHARED} timed step(s) "
            f"{[round(r['steps_per_s'], 3) for r in ranks]} "
            f"steps/s, peak {[round(r['peak_gib'], 2) for r in ranks]} GiB a rank (two processes "
            f"on one card: not a scaling figure); DPM-20 generate({DDP_BATCH}) sharded over the "
            f"ranks: images {got.shape}, bit-equal to one process sampling the same noise in "
            f"two batches of 8 {same8} (max_abs_err {err8:.3e}); against one process's "
            f"generate({DDP_BATCH}) at batch {DDP_BATCH}: ray-drop mask agreement "
            f"{mask_agree:.6f}, kept-pixel max_abs_err {img_err:.3e}, mean {img_mean:.3e}; "
            f"card {card}")
        bad = []
        if not all(r["replicas_equal"] for r in ranks):
            bad.append("the replicas differ after the step")
        if not r0["dropout_draws_differ"]:
            bad.append("after train_lidm's set-up the ranks draw the same dropout masks")
        if any(r["launches"] != r0["structure"] for r in ranks):
            bad.append("a rank's launches differ from the step's structure")
        if got.shape != want.shape or not np.isfinite(got).all():
            bad.append("bad generated images")
        if not (r0["equal_halves"] and same8):
            bad.append("the sharded step or request differs from one process running the "
                       "ranks' halves")
        # against batch 16: cuDNN takes other algorithms at batch 8, whose bf16
        # roundings flip Adam's first update (about lr * sign(g)) where g is
        # near 0, and which DPM-20 carries into the images (measured ranges,
        # PERF.md section 6)
        if not (r0["diff_lr_16"] <= 2.01 and r0["share_off_16"] <= 1e-2
                and abs(r0["loss"] - loss16) <= 1e-3 * loss16
                and abs(r0["grad_norm"] - norm16) <= 2e-3 * norm16 and mask_agree >= 0.98):
            bad.append("the sharded step or request is too far from one process's at batch 16")
        if bad:
            raise AssertionError("ddp (b): " + "; ".join(bad))

    def _ddp_other_device(self, n):
        """K1-K4 on the last card while card 0 is current, against their
        plain versions (every launch enters its tensors' device)."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import chamfer as CH
        from lidar_layout_tpu_torch.ops import groupnorm as G

        if n < 2:
            log("ddp: one card, so K1-K4 on a card other than the current one are not run "
                "(unverified here)")
            return
        dev = torch.device("cuda", n - 1)
        torch.cuda.set_device(0)
        g = torch.Generator(device=dev).manual_seed(5)
        q, k, v, do = (torch.randn((2, 8, 512, 32), generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = A._launch(q, k, v, None, with_lse=True)
        self._check("flash_attention", o, A._attend_ref(q, k, v, None), 2e-2, 2e-2,
                    f"on cuda:{n - 1} while cuda:0 is current", record=False)
        dq, dk, dv = A.flash_attention_bwd(q, k, v, o, do, lse)
        x = torch.randn((2, 256, 16, 128), generator=g, device=dev)
        gamma = torch.rand(256, generator=g, device=dev) + 0.5
        beta = torch.randn(256, generator=g, device=dev)
        self._check("group_norm", G._launch(x, gamma, beta, 32, 1e-6, True),
                    G._ref(x, gamma, beta, 32, 1e-6, True), 1e-4, 1e-4,
                    f"on cuda:{n - 1} while cuda:0 is current", record=False)
        dy = torch.randn_like(x)
        got = G._launch_bwd(x, gamma, beta, dy, 32, 1e-6, True)[0]
        want = G.group_norm_bwd(x.cpu(), gamma.cpu(), beta.cpu(), dy.cpu(), 32, 1e-6, True)[0]
        self._check("group_norm_bwd", got, want.to(dev), 1e-4, 1e-4,
                    f"on cuda:{n - 1} while cuda:0 is current", record=False)
        xs, ys = (torch.rand((4096, 3), generator=g, device=dev) for _ in range(2))
        self._check("chamfer_nn", CH.nn_dist_one_way(xs, ys),
                    CH.nn_dist_one_way(xs.cpu(), ys.cpu()).to(dev), 1e-6, 1e-5,
                    f"on cuda:{n - 1} while cuda:0 is current", record=False)
        ref = [t.float().cpu().requires_grad_() for t in (q, k, v)]
        A._attend_ref(*ref, None).backward(do.float().cpu())
        for name_, a, b in (("dq", dq, ref[0].grad), ("dk", dk, ref[1].grad),
                            ("dv", dv, ref[2].grad)):
            self._check("flash_attention_bwd", a.float(), b.to(dev), 5e-2, 5e-2,
                        f"{name_} on cuda:{n - 1} while cuda:0 is current", record=False)

    # ---------------------------------------------------------------------- sp
    def sp(self):
        """The spatial (sp) axis: the full-width flagship (f32, TF32 off,
        seeded weights) W-sharded in SP_RANKS ranks sharing one card over
        gloo, or through NCCL at world = card count with 4 cards or more
        (sp by JAX's rule); the gathered encode and apply_model against one
        process's unsharded forward within SP_TOL; each rank's launches
        against the structure and its hooks; then the kernels at the shapes
        the ranks saw (``_sp_kernels``)."""
        import torch
        from lidar_layout_tpu_torch.parallel.dryrun import spawn

        card, n_cards = card_line(), torch.cuda.device_count()
        _ddp_exact()
        t0 = time.perf_counter()
        model = seed_weights(ddp_flagship(), 0)
        image, latent, t = sp_inputs(model.cfg.timesteps)
        with torch.no_grad():
            want_z = model.encode_first_stage(torch.from_numpy(image).cuda()).cpu().numpy()
            want_eps = model.apply_model(torch.from_numpy(latent).cuda(),
                                         torch.from_numpy(t).cuda()).cpu().numpy()
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        nccl = n_cards >= 4
        world = n_cards if nccl else SP_RANKS
        t0, started = time.perf_counter(), time.time()
        ranks = spawn(sp_rank, world, (), device="cuda",
                      backend=None if nccl else "gloo", env_store=nccl, timeout=600)
        wall = time.perf_counter() - t0
        torch.backends.cudnn.deterministic = False
        ends = (max(r["entered"] for r in ranks) - started,
                time.time() - min(r["left"] for r in ranks))
        r0 = ranks[0]
        errs = {}
        for key, got, want in (("encode", r0["z"], want_z), ("apply_model", r0["eps"], want_eps)):
            errs[key] = (float(np.abs(got - want).max()), float(np.abs(want).max()),
                         got.shape == want.shape and bool(np.isfinite(got).all())
                         and bool(np.all(np.abs(got - want) <= SP_TOL + SP_TOL * np.abs(want))))
        hooked = {k: sum(c for (name, _), c in r0["calls"].items()
                         if name == ("group_norm_split" if k.startswith("group_norm")
                                     else k)) for k in r0["structure"]}
        log(f"sp: {world} ranks over {r0['backend']} on {n_cards} card(s), mesh {r0['mesh']} "
            f"({wall:.1f} s with the ranks' start {ends[0]:.1f} s and exit {ends[1]:.1f} s; "
            f"one process's unsharded forward {t_ref:.1f} s); the full-width flagship, f32, "
            f"batch {SP_BATCH}, a (64, 1024) image and a (16, 128) latent at t = "
            f"{int(t[0])}: W-sharded encode against the unsharded max_abs_err "
            f"{errs['encode'][0]:.3e} (|ref| max {errs['encode'][1]:.3e}), apply_model "
            f"max_abs_err {errs['apply_model'][0]:.3e} (|ref| max {errs['apply_model'][1]:.3e}); "
            f"tol {SP_TOL:g} + {SP_TOL:g}|ref|; every rank gathered the same output "
            f"{all(r['same'] for r in ranks)}; the sharded encode and apply_model "
            f"{[round(r['seconds'], 3) for r in ranks]} s a rank (warm-up "
            f"{[round(r['warm_s'], 3) for r in ranks]}; ranks sharing a card and talking "
            f"through the host: a rehearsal, not a scaling figure); launches a rank "
            f"{[r['launches'] for r in ranks]} (structure {r0['structure']}, hooks {hooked}); "
            f"other kernels {[r['others'] for r in ranks]}; card {card}")
        bad = []
        for key, (_, _, ok) in errs.items():
            if not ok:
                bad.append(f"the W-sharded {key} differs from the unsharded forward")
        if not all(r["same"] for r in ranks):
            bad.append("the ranks gathered different outputs")
        if any(r["launches"] != r0["structure"] for r in ranks) or hooked != r0["structure"]:
            bad.append("a rank's launches differ from the structure")
        if any(any(r["others"].values()) for r in ranks):
            bad.append("a rank launched a kernel of the unsharded path")
        if bad:
            raise AssertionError("sp: " + "; ".join(bad))
        self.sp_launches = dict(r0["launches"])
        self.sp_shapes, self.sp_size = r0["calls"], r0["mesh"]["sp"]
        self.kernel_err["sp_encode"], self.kernel_err["sp_apply_model"] = (
            errs["encode"][0], errs["apply_model"][0])
        self._sp_kernels()

    def _sp_kernels(self):
        """The cross-length K1 (f32 and bf16) and the split K3's two kernels
        (f32) at every shape of the sp phase's ranks against their plain
        versions, each bit for bit over two launches; the split K3's kernels
        over the sp shards of a whole-width tensor, merged, against K3's
        plain version on it."""
        import torch
        from lidar_layout_tpu_torch.ops import attention as A
        from lidar_layout_tpu_torch.ops import groupnorm as G
        from lidar_layout_tpu_torch.parallel.collectives import merge_shard_stats

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(12)
        tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
        sp = self.sp_size
        log(f"sp kernels at the ranks' shapes ({sp} shards; max_abs_err recorded in f32, the "
            f"path's dtype):")

        def check(name, got, want, atol, rtol, what, record=True):
            self._check(name, got, want, atol, rtol, what, record=False)
            if record:
                self.kernel_err[name] = max(self.kernel_err[name], max_err(got, want)[0])
        for (name, key), count in sorted(self.sp_shapes.items()):
            if name == "flash_attention_xl":
                b, h, sq, skv, d = key
                for dtype in (torch.float32, torch.bfloat16):
                    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
                    k, v = (torch.randn((b, h, skv, d), generator=gen, device=dev).to(dtype)
                            for _ in range(2))
                    o1, o2 = A._launch_xl(q, k, v), A._launch_xl(q, k, v)
                    check(name, o1, A._attend_ref(q, k, v), *tol[dtype],
                          f"{key} {str(dtype)[6:]} x{count} a rank; two launches bit for bit "
                          f"{bool(torch.equal(o1, o2))}", record=dtype == torch.float32)
                    if not torch.equal(o1, o2):
                        raise AssertionError("the cross-length K1 is not deterministic")
                continue
            b, c, hh, ww, groups, act = key
            x = torch.randn((b, c, hh, ww * sp), generator=gen, device=dev) * 2 + 0.3
            gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
            beta = 0.1 * torch.randn(c, generator=gen, device=dev)
            shards = [s.contiguous() for s in x.split(ww, dim=-1)]
            count_ = c // groups * hh * ww
            st1, st2 = G.group_norm_stats(shards[0], groups), G.group_norm_stats(shards[0], groups)
            want = G._stats_ref(shards[0], groups)
            check("group_norm_stats", st1[..., 0], want[..., 0], 1e-5, 1e-5,
                  f"{key} mean x{count} a rank")
            check("group_norm_stats", st1[..., 1], want[..., 1], 1e-5, 1e-5,
                  f"{key} M2 x{count} a rank", record=False)
            merged = merge_shard_stats(torch.stack([G.group_norm_stats(s, groups)
                                                    for s in shards]), count_)
            y1 = G.group_norm_apply(shards[0], merged, gamma, beta, groups, count_ * sp, 1e-6,
                                    act)
            y2 = G.group_norm_apply(shards[0], merged, gamma, beta, groups, count_ * sp, 1e-6,
                                    act)
            check("group_norm_apply", y1, G._apply_ref(shards[0], merged, gamma, beta, groups,
                                                       count_ * sp, 1e-6, act),
                  1e-5, 1e-5, f"{key} x{count} a rank; two launches bit for bit (stats and "
                  f"apply) {bool(torch.equal(st1, st2) and torch.equal(y1, y2))}")
            if not (torch.equal(st1, st2) and torch.equal(y1, y2)):
                raise AssertionError("the split K3 is not deterministic")
            whole = torch.cat([G.group_norm_apply(s, merged, gamma, beta, groups, count_ * sp,
                                                  1e-6, act) for s in shards], dim=-1)
            check("group_norm_apply", whole, G._ref(x, gamma, beta, groups, 1e-6, act),
                  1e-4, 1e-5, f"{key} over {sp} shards, merged, against K3's plain version on "
                  f"the whole width", record=False)

    # ------------------------------------------------------------------ timing
    def timing(self):
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import attention as A

        shapes = self._main_shapes()
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(5)
        card = card_line()
        totals = {}
        saved = read_counts()
        log(f"timing on {card}: per call, device ms (torch.profiler kernel time, mean of "
            f"back-to-back calls; K1/K2 and SDPA the median of 3 rounds in turns); 'events' "
            f"is the wall time per call from CUDA events, which includes the host's launch "
            f"rate; clocks at the start: {clock_line()}")
        totals["flash_attention"] = self._time_k1(gen, shapes["flash_attention"],
                                                  N_MAIN // BATCH)
        # K3, by shape and by class (where the launches come from, and the
        # size of a group's span)
        tot = collections.Counter()
        classes = collections.defaultdict(collections.Counter)
        for (b, c, hh, ww, groups, act), count in sorted(shapes["group_norm"].items()):
            t = self._time_k3(gen, (b, c, hh, ww, groups, act), f"x{count}/request")
            span_kb = c // groups * hh * ww * 2 / 1024
            for key, val in t.items():
                tot[key] += count * val * (N_MAIN // BATCH)
            for origin in ("unet", "decoder"):
                n = self.gn_where[(b, c, hh, ww, groups, act), origin]
                name = ("U-Net" if origin == "unet" else
                        "VQ decoder, 128 KB+ groups" if span_kb >= 128 else
                        "VQ decoder, groups under 128 KB")
                for key in ("ms", "library_ms", "bound_ms", "copy_ms"):
                    classes[name][key] += n * t[key]
                classes[name]["launches"] += n
        for name, cl in classes.items():
            log(f"  K3 class {name}, per DPM-20 request (batch {BATCH}): {cl['launches']} "
                f"launches | kernel {cl['ms']:.4f} ms | group_norm+silu {cl['library_ms']:.4f} "
                f"({cl['ms'] / cl['library_ms']:.3f}x) | bound {cl['bound_ms']:.4f} (kernel at "
                f"{100 * cl['bound_ms'] / cl['ms']:.1f}% of it) | copy_ of x {cl['copy_ms']:.4f}")
        totals["group_norm"] = tot
        # K3 at the layout path's shapes; summed over the guided layout run
        # (generate(32), DPM-20, cfg_scale 2.0: the U-Net at the doubled
        # batch). The unguided U-Net's shapes (cfg 1, half the batch) enter
        # no sum and are not timed
        log(f"  K3 at the guided layout request's shapes (per DPM-20 request, batch {BATCH}):")
        tot = collections.Counter()
        for (key, origin), count in sorted(self._layout_shapes().items()):
            if origin == "unet cfg 1":
                continue
            t = self._time_k3(gen, key, f"x{count}/request, layout {origin}")
            for name, val in t.items():
                tot[name] += count * val * (N_MAIN // BATCH)
        self.run_totals = {"group_norm": {"layout": tot}}
        log(f"  group_norm over the guided layout run (generate({N_MAIN}), DPM-20, cfg_scale "
            f"{LAYOUT_CFG_SCALE:g}, batch {BATCH}; sum over shapes of launches x time): kernel "
            f"{tot['ms']:.3f} ms (events {tot['events_ms']:.3f}) | plain {tot['plain_ms']:.3f} | "
            f"library {tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | bound "
            f"{tot['bound_ms']:.3f} (kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}% of it)")
        totals["flash_attention_bwd"] = self._timing_bwd(gen)
        totals["group_norm_bwd"] = self._timing_gn_bwd(gen, self._train_shapes(), "flagship")
        # the layout paths: K1 over a LayoutDiffusion request, K3's backward
        # over the layout model's timed training steps
        self.run_totals["flash_attention"] = {"layout_boxes": self._timing_boxes_attention(gen)}
        fwd, bwd = self._timing_boxes_train_attention(gen)
        self.run_totals["flash_attention"]["layout_boxes_train"] = fwd
        self.run_totals["flash_attention_bwd"] = {"layout_boxes_train": bwd}
        self.run_totals["group_norm_bwd"] = {"layout_train": self._timing_gn_bwd(
            gen, self._train_shapes(layout=True), "layout model")}
        ae_fwd, ae_bwd = self._timing_ae(gen)
        self.run_totals["group_norm"]["ae_train"] = ae_fwd
        self.run_totals["group_norm_bwd"]["ae_train"] = ae_bwd
        self._timing_coarse(gen)
        self._timing_dense(gen)
        self._timing_cond(gen)
        self._timing_families(gen)
        self._timing_sonata(gen)
        self._timing_cond_train(gen)
        self._timing_split(gen)
        if self.ae_bf16_shapes is not None:
            self._timing_ae_bf16(gen)
        else:
            log("  the bf16 AE's K3 shapes come from the ae_bf16 phase, which did not run")
        totals["chamfer_nn"] = self._timing_chamfer()
        if self.ae_eval_clouds is not None:
            self.run_totals.setdefault("chamfer_nn", {})["ae_eval"] = self._timing_chamfer(
                list(zip(*self.ae_eval_clouds)), "eval_ae's")
        for name, fn in counters().items():
            fn.launches = saved[name]
        runs = {"flash_attention_bwd": f"{TRAIN_STEPS} training steps (batch {TRAIN_BATCH})",
                "group_norm_bwd": f"{TRAIN_STEPS} training steps (batch {TRAIN_BATCH})",
                "chamfer_nn": f"the eval's CD ({N_MAIN} pairs, 2 launches each)"}
        for name, tot in totals.items():
            run = runs.get(name, f"the main DPM-20 run (generate({N_MAIN}), batch {BATCH})")
            extra = f" | SFU floor {tot['sfu_ms']:.3f}" if "sfu_ms" in tot else ""
            if "warm_ms" in tot:
                extra += f" | warm kernel {tot['warm_ms']:.3f}"
            if "first_ms" in tot:   # one device_ms of each, not in turns
                extra += (f" | first round alone: kernel {tot['first_ms']:.3f}, library "
                          f"{tot['first_library_ms']:.3f} "
                          f"({tot['first_ms'] / tot['first_library_ms']:.3f}x)")
            log(f"  {name} over {run}; sum over shapes of launches x time): kernel "
                f"{tot['ms']:.3f} ms (events {tot['events_ms']:.3f}) | plain "
                f"{tot['plain_ms']:.3f} | library "
                f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x) | bound "
                f"{tot['bound_ms']:.3f}{extra}")
        self._timing_sp(gen, totals)
        for name, fn in sp_counters().items():
            fn.launches = self.sp_launches.get(name, 0)
        log(f"  timings taken with CUDA events because torch.profiler saw no device "
            f"time: {len(EVENT_TIMINGS)} {EVENT_TIMINGS}")
        self.totals = totals

    def _time_k1(self, gen, counts, runs, label="", dtype=None):
        """K1 in bf16 (or ``dtype``) at each shape of ``counts`` (launches a
        request): the kernel beside SDPA in turns, the plain version, the
        bound (operations at the dtype's peak) and the SFU floor; summed
        over ``runs`` requests."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import attention as A

        dtype = dtype or torch.bfloat16
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
        dev = torch.device("cuda")
        tot = collections.Counter()
        for (b, h, s, d), count in sorted(counts.items()):
            q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            cost = A.attention_cost(b, h, s, d, q.element_size())
            flops, nbytes = cost["flops"], cost["bytes"]
            kms, lms, krounds, lrounds = paired_ms(
                lambda: A.flash_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v), 20)
            t = {"ms": kms, "events_ms": cuda_time(lambda: A.flash_attention(q, k, v), 20),
                 "plain_ms": device_ms(lambda: A._attend_ref(q, k, v), 5), "library_ms": lms,
                 "first_ms": krounds[0], "first_library_ms": lrounds[0]}
            bound_flops, bound_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            t["bound_ms"] = max(bound_flops, bound_bytes)
            bound_gate(f"K1 {(b, h, s, d)} {str(dtype)[6:]}", t["bound_ms"], t["ms"])
            t["sfu_ms"] = cost["transcendentals"] / sfu_ex2_per_ms()
            log(f"  K1 {(b, h, s, d)} {str(dtype)[6:]} x{count}/request{label}: kernel {t['ms']:.4f} (events "
                f"{t['events_ms']:.4f}) | plain "
                f"{t['plain_ms']:.4f} | sdpa {t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.3f}x)"
                f" | bound {t['bound_ms']:.4f} "
                f"({'operations' if bound_flops >= bound_bytes else 'bytes'}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; kernel at "
                f"{100 * t['bound_ms'] / t['ms']:.1f}% of it) | SFU floor {t['sfu_ms']:.4f} "
                f"({cost['transcendentals'] / 1e6:.0f} M exp2; kernel at "
                f"{100 * t['sfu_ms'] / t['ms']:.1f}% of it) | {flops / t['ms'] / 1e9:.1f} TFLOP/s"
                f" | rounds kernel {[round(x, 4) for x in krounds]} sdpa "
                f"{[round(x, 4) for x in lrounds]} (first round alone "
                f"{krounds[0] / lrounds[0]:.3f}x) | clocks {clock_line()}")
            for key, val in t.items():
                tot[key] += count * val * runs
            tot["bound_ops_ms"] += count * bound_flops * runs
            tot["bound_bytes_ms"] += count * bound_bytes * runs
        return tot

    def _time_k3(self, gen, key, label, dtype=None, eps=1e-6):
        """K3 forward at one shape (bf16 unless ``dtype``): device ms of the
        kernel (and wall ms from CUDA events), the plain version,
        F.group_norm (+ F.silu) and copy_ of the same bytes, and the bound
        with its two parts, each on inputs out of L2 (``cold_ring``); and
        ``warm_ms``, the kernel back to back on one input (the older method),
        which reads L2 where x fits and is not held to the bound. A
        shape timed before (another path's) is taken from then."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import groupnorm as G

        b, c, hh, ww, groups, act = key
        dtype = dtype or torch.bfloat16
        memo = (key, dtype, eps, False)
        if memo in self.k3_times:
            log(f"  K3 {(b, c, hh, ww)} G={groups} act={act} {str(dtype)[6:]} {label}: as "
                f"timed above")
            return self.k3_times[memo]
        dev = torch.device("cuda")
        gamma = torch.ones(c, device=dev)
        beta = torch.zeros(c, device=dev)
        gl, bl = gamma.to(dtype), beta.to(dtype)

        def lib(x):
            y = F.group_norm(x, groups, gl, bl, eps)
            return F.silu(y) if act else y
        itemsize = torch.tensor([], dtype=dtype).element_size()
        cost = G.group_norm_cost(b, c, hh * ww, groups, itemsize, act)
        nbytes, ops = cost["bytes"], cost["flops"]
        # every call finds its x out of L2, as a layer's input is in a model
        call, copies = cold_ring(lambda: (torch.randn((b, c, hh, ww), generator=gen,
                                                      device=dev).to(dtype),), nbytes)
        span_kb = c // groups * hh * ww * itemsize / 1024
        path = path_name(G.kernel_path(dtype, c, hh * ww, groups))

        def kernel():
            return call(lambda x: G.group_norm(x, gamma, beta, groups, eps, act))
        warm = torch.randn((b, c, hh, ww), generator=gen, device=dev).to(dtype)
        t = {"ms": device_ms(kernel, 20), "events_ms": cuda_time(kernel, 20),
             "warm_ms": device_ms(lambda: G.group_norm(warm, gamma, beta, groups, eps, act), 20),
             "plain_ms": device_ms(lambda: call(lambda x: G._ref(x, gamma, beta, groups, eps,
                                                                 act)), 5),
             "library_ms": device_ms(lambda: call(lib), 20),
             # copy_ moves the same bytes: the rate the card reaches
             "copy_ms": device_ms(lambda: call(lambda x: torch.empty_like(x).copy_(x)), 20)}
        t["bound_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_ops_ms"] = ops / PEAK_F32 * 1e3
        t["bound_ms"] = max(t["bound_bytes_ms"], t["bound_ops_ms"])
        bound_gate(f"K3 {(b, c, hh, ww)} G={groups} {str(dtype)[6:]}", t["bound_ms"], t["ms"])
        log(f"  K3 {(b, c, hh, ww)} G={groups} act={act} {str(dtype)[6:]} {label} ({span_kb:g} "
            f"KB groups, {path}): kernel "
            f"{t['ms']:.4f} (events {t['events_ms']:.4f}; warm {t['warm_ms']:.4f}) | plain "
            f"{t['plain_ms']:.4f} | "
            f"group_norm+silu "
            f"{t['library_ms']:.4f} | bound {t['bound_ms']:.4f} "
            f"({'bytes' if t['bound_bytes_ms'] >= t['bound_ops_ms'] else 'operations'}; "
            f"{nbytes / 1e6:.1f} MB; kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of it) "
            f"| {nbytes / t['ms'] / 1e6:.0f} GB/s | copy_ of x {t['copy_ms']:.4f} "
            f"({100 * t['bound_ms'] / t['copy_ms']:.1f}% of the bound) | {copies} input "
            f"copies in turn")
        self.k3_times[memo] = t
        return t

    def _timing_bwd(self, gen, counts=None, label="training step"):
        """K2 at a training step's shapes (``counts``, the flagship's by
        default): kernel, plain version, the backward of
        scaled_dot_product_attention, and the bound; summed over
        TRAIN_STEPS steps."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import attention as A

        dev = torch.device("cuda")
        tot = collections.Counter()
        counts = self._train_shapes()["flash_attention_bwd"] if counts is None else counts
        for (b, h, s, d), count in sorted(counts.items()):
            q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            o, lse = A._launch(q, k, v, None, with_lse=True)
            ql, kl, vl = (t_.clone().requires_grad_() for t_ in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl)
            cost = A.attention_cost(b, h, s, d, 2, backward=True)
            flops, nbytes = cost["flops"], cost["bytes"]
            kms, lms, krounds, lrounds = paired_ms(
                lambda: A.flash_attention_bwd(q, k, v, o, do, lse),
                lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True), 10)
            t = {"ms": kms,
                 "events_ms": cuda_time(lambda: A.flash_attention_bwd(q, k, v, o, do, lse), 10),
                 "plain_ms": device_ms(lambda: A._attend_bwd_ref(q, k, v, o, do, lse), 3),
                 "library_ms": lms, "first_ms": krounds[0], "first_library_ms": lrounds[0]}
            bound_flops, bound_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            t["bound_ms"] = max(bound_flops, bound_bytes)
            bound_gate(f"K2 {(b, h, s, d)} bf16", t["bound_ms"], t["ms"])
            t["sfu_ms"] = cost["transcendentals"] / sfu_ex2_per_ms()
            log(f"  K2 {(b, h, s, d)} bf16 x{count}/step: kernel {t['ms']:.4f} (events "
                f"{t['events_ms']:.4f}) | plain {t['plain_ms']:.4f} | sdpa backward "
                f"{t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.3f}x) | bound "
                f"{t['bound_ms']:.4f} ({'operations' if bound_flops >= bound_bytes else 'bytes'}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; kernel at "
                f"{100 * t['bound_ms'] / t['ms']:.1f}% of it) | SFU floor {t['sfu_ms']:.4f} "
                f"({cost['transcendentals'] / 1e6:.0f} M exp2; kernel at "
                f"{100 * t['sfu_ms'] / t['ms']:.1f}% of it) | {flops / t['ms'] / 1e9:.1f} TFLOP/s"
                f" | rounds kernel {[round(x, 4) for x in krounds]} sdpa backward "
                f"{[round(x, 4) for x in lrounds]} (first round alone "
                f"{krounds[0] / lrounds[0]:.3f}x) | clocks {clock_line()}")
            for key, val in t.items():
                tot[key] += count * val * TRAIN_STEPS
                tot[f"step_{key}"] += count * val
            tot["bound_ops_ms"] += count * bound_flops * TRAIN_STEPS
            tot["bound_bytes_ms"] += count * bound_bytes * TRAIN_STEPS
            del q, k, v, do, o, lse, ql, kl, vl, out
        log(f"  K2 per {label} (sum over shapes): kernel {tot['step_ms']:.3f} ms | plain "
            f"{tot['step_plain_ms']:.3f} | sdpa backward {tot['step_library_ms']:.3f} "
            f"({tot['step_ms'] / tot['step_library_ms']:.3f}x) | bound "
            f"{tot['step_bound_ms']:.3f} | SFU floor {tot['step_sfu_ms']:.3f} | first round "
            f"alone: kernel {tot['step_first_ms']:.3f}, sdpa backward "
            f"{tot['step_first_library_ms']:.3f} "
            f"({tot['step_first_ms'] / tot['step_first_library_ms']:.3f}x)")
        torch.cuda.empty_cache()
        return tot

    def _timing_chamfer(self, clouds=None, label="the eval's"):
        """K4 over the eval's launches (reference -> sample and back for
        every pair; ``clouds``, (x, y) numpy pairs, for another run's),
        each set run back to back: the kernel, the plain
        version, torch.cdist squared then amin (row-chunked as the plain
        version), the bound summed over the launches (the larger of one
        FMNMX a pair at 64 a clock per SM and the bytes; beside it the
        direct form's 9 operations a pair at 67 TFLOP/s), and the share of
        points K4 re-checked more than once a split."""
        import torch
        from lidar_layout_tpu_torch.ops import chamfer as C

        if clouds is None and self.eval_clouds is None:
            raise RuntimeError("timing: K4 is timed on the eval's clouds; run the eval phase")

        def library(x, y):
            return torch.cat([torch.cdist(x[i:i + 4096], y).square().amin(dim=1)
                              for i in range(0, x.shape[0], 4096)])

        pairs = []
        for ref, smp in clouds if clouds is not None else zip(*self.eval_clouds):
            r, s = (torch.from_numpy(c).to("cuda") for c in (ref, smp))
            pairs += [(r, s), (s, r)]

        def every(fn):
            return lambda: [fn(x, y) for x, y in pairs]

        tot = collections.Counter({
            "ms": device_ms(every(C.nn_dist_one_way), 5, 1),
            "events_ms": cuda_time(every(C.nn_dist_one_way), 5, 1),
            "plain_ms": device_ms(every(C._nn_dist_ref), 1, 1),
            "library_ms": device_ms(every(library), 1, 1)})
        for x, y in pairs:
            n, m = x.shape[0], y.shape[0]
            tot["bound_ops_ms"] += n * m / (FMNMX_PER_CLOCK * sm_clocks_per_ms())
            tot["direct_bound_ms"] += 9 * n * m / PEAK_F32 * 1e3
            tot["bound_bytes_ms"] += (12 * (n + m) + 4 * n) / HBM_BYTES_PER_S * 1e3
            tot["pairs"] += n * m
            _, direct, splits, worst = C.nn_dist_stats(x, y)
            tot["points"] += n
            tot["point_splits"] += n * splits
            tot["direct"] += int(direct.sum())
            tot["rechecked"] += int((direct > C.RECHECK * splits).sum())
            tot["worst"] = max(tot["worst"], worst)
        tot["bound_ms"] = max(tot["bound_ops_ms"], tot["bound_bytes_ms"])
        bound_gate(f"K4 over {label} launches", tot["bound_ms"], tot["ms"])
        log(f"  K4 over {label} {len(pairs)} launches ({tot['pairs'] / 1e9:.3f} G point "
            f"pairs): kernel {tot['ms']:.3f} ms (events {tot['events_ms']:.3f}) | plain "
            f"{tot['plain_ms']:.3f} | cdist^2 + amin {tot['library_ms']:.3f} | bound "
            f"{tot['bound_ms']:.3f} ({'operations' if tot['bound_ops_ms'] >= tot['bound_bytes_ms'] else 'bytes'}: "
            f"one FMNMX a pair at {FMNMX_PER_CLOCK} a clock per SM; kernel at "
            f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it) | the direct form's bound "
            f"{tot['direct_bound_ms']:.3f} (9 operations a pair at 67 TFLOP/s f32) | "
            f"{tot['pairs'] / tot['ms'] / 1e9:.1f} G pairs/ms | direct forms a point and split "
            f"{tot['direct'] / tot['point_splits']:.4f}; points re-checked (more than one "
            f"chunk a split) {100 * tot['rechecked'] / tot['points']:.2f}%; largest "
            f"candidate error {tot['worst']:.3f} of the model's bound")
        return tot

    def _timing_boxes_attention(self, gen):
        """K1 at LayoutDiffusion's (256, 8, 1, 64) f32, as its CrossAttention
        hands it q, k and v: the kernel and SDPA in turns, the plain version,
        the bound (operations at the f32 rate, or the bytes), summed over the
        launches of one DDIM-100 request."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import attention as A

        q, k, v = self._box_qkv(gen)
        n, h, _, d = q.shape
        cost = A.attention_cost(n, h, 1, d, 4)
        kms, lms, krounds, lrounds = paired_ms(
            lambda: A.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), 50)
        t = {"ms": kms, "events_ms": cuda_time(lambda: A.flash_attention(q, k, v), 50),
             "plain_ms": device_ms(lambda: A._attend_ref(q, k, v), 20), "library_ms": lms}
        bound_ops = cost["flops"] / PEAK_F32 * 1e3
        bound_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(bound_ops, bound_bytes)
        bound_gate(f"K1 ({n}, {h}, 1, {d}) f32 (boxes)", t["bound_ms"], t["ms"])
        count = self._box_attention_count()
        log(f"  K1 ({n}, {h}, 1, {d}) f32 x{count}/LayoutDiffusion request: kernel "
            f"{t['ms']:.5f} (events {t['events_ms']:.5f}) | plain {t['plain_ms']:.5f} | sdpa "
            f"{t['library_ms']:.5f} ({t['ms'] / t['library_ms']:.3f}x) | bound "
            f"{t['bound_ms']:.6f} ({'operations' if bound_ops >= bound_bytes else 'bytes'}; "
            f"{cost['flops'] / 1e6:.2f} MFLOP, {cost['bytes'] / 1e6:.2f} MB; kernel at "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it) | rounds kernel "
            f"{[round(x, 5) for x in krounds]} sdpa {[round(x, 5) for x in lrounds]}")
        tot = collections.Counter({key: count * val for key, val in t.items()})
        tot["bound_ops_ms"], tot["bound_bytes_ms"] = count * bound_ops, count * bound_bytes
        log(f"  K1 over a LayoutDiffusion request ({count} launches): kernel {tot['ms']:.3f} ms "
            f"(events {tot['events_ms']:.3f}) | plain {tot['plain_ms']:.3f} | sdpa "
            f"{tot['library_ms']:.3f} | bound {tot['bound_ms']:.4f}")
        return tot

    def _timing_boxes_train_attention(self, gen):
        """K1 with its log-sum-exp and K2 at LayoutDiffusion's (256, 8, 1, 64)
        f32, on CrossAttention's layout, summed over the TRAIN_STEPS timed
        training steps (the layout_boxes_train phase's launches, or every
        CrossAttention forward and backward a step): each beside SDPA's
        forward and backward (in turns), the plain versions, and the bound
        (operations at the f32 rate, or the bytes: q, k, v read and o
        written; backward q, k, v, o, dO read and dq, dk, dv written)."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.nn.attention import CrossAttention
        from lidar_layout_tpu_torch.ops import attention as A

        q, k, v, do = self._box_qkv(gen, 4)
        n, h, _, d = q.shape
        o, lse = A._launch(q, k, v, None, with_lse=True)
        ql, kl, vl = (t_.clone().requires_grad_() for t_ in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl)
        launches = self.layout_boxes_train_launches
        if not launches:
            from lidar_layout_tpu_torch.sample_layout import build_model

            model = build_model(device="cuda")
            per_step = sum(isinstance(m, CrossAttention) for m in model.unet.modules())
            launches = {"flash_attention": per_step * TRAIN_STEPS,
                        "flash_attention_bwd": per_step * TRAIN_STEPS}
            del model
            torch.cuda.empty_cache()
        totals = []
        for name, kernel, library, plain, backward in (
                ("K1 with lse", lambda: A._launch(q, k, v, None, with_lse=True),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 lambda: (A._attend_ref(q, k, v), A._lse_ref(q, k)), False),
                ("K2", lambda: A.flash_attention_bwd(q, k, v, o, do, lse),
                 lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
                 lambda: A._attend_bwd_ref(q, k, v, o, do, lse), True)):
            cost = A.attention_cost(n, h, 1, d, 4, backward=backward)
            kms, lms, krounds, lrounds = paired_ms(kernel, library, 50)
            t = {"ms": kms, "events_ms": cuda_time(kernel, 50), "plain_ms": device_ms(plain, 20),
                 "library_ms": lms}
            bound_ops = cost["flops"] / PEAK_F32 * 1e3
            bound_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
            t["bound_ms"] = max(bound_ops, bound_bytes)
            bound_gate(f"{name} ({n}, {h}, 1, {d}) f32 (boxes train)", t["bound_ms"], t["ms"])
            count = launches["flash_attention_bwd" if backward else "flash_attention"]
            log(f"  {name} ({n}, {h}, 1, {d}) f32 x{count // TRAIN_STEPS}/LayoutDiffusion "
                f"training step: kernel {t['ms']:.5f} (events {t['events_ms']:.5f}) | plain "
                f"{t['plain_ms']:.5f} | sdpa {'backward' if backward else 'forward'} "
                f"{t['library_ms']:.5f} ({t['ms'] / t['library_ms']:.3f}x) | bound "
                f"{t['bound_ms']:.6f} ({'operations' if bound_ops >= bound_bytes else 'bytes'}; "
                f"{cost['flops'] / 1e6:.2f} MFLOP, {cost['bytes'] / 1e6:.2f} MB; kernel at "
                f"{100 * t['bound_ms'] / t['ms']:.1f}% of it) | rounds kernel "
                f"{[round(x, 5) for x in krounds]} sdpa {[round(x, 5) for x in lrounds]}")
            tot = collections.Counter({key: count * val for key, val in t.items()})
            tot["bound_ops_ms"], tot["bound_bytes_ms"] = count * bound_ops, count * bound_bytes
            log(f"  {name} over {TRAIN_STEPS} LayoutDiffusion training steps ({count} launches): "
                f"kernel {tot['ms']:.3f} ms (events {tot['events_ms']:.3f}) | plain "
                f"{tot['plain_ms']:.3f} | sdpa {tot['library_ms']:.3f} | bound "
                f"{tot['bound_ms']:.4f}")
            totals.append(tot)
        del q, k, v, do, o, lse, ql, kl, vl, out
        return totals

    def _time_k3_bwd(self, gen, key, label, dtype=None, eps=1e-6):
        """K3's backward at one shape (bf16 unless ``dtype``): the kernel,
        the plain version, the autograd backward of F.group_norm (+ F.silu),
        in turns with the kernel, and the bound with its two parts, on
        inputs out of L2; ``warm_ms`` the kernel back to back on one set, as
        ``_time_k3``; a shape timed before is taken from then."""
        import torch
        import torch.nn.functional as F
        from lidar_layout_tpu_torch.ops import groupnorm as G

        b, c, hh, ww, groups, act = key
        dtype = dtype or torch.bfloat16
        memo = (key, dtype, eps, True)
        if memo in self.k3_times:
            log(f"  K3 backward {(b, c, hh, ww)} G={groups} act={act} {str(dtype)[6:]} {label}: "
                f"as timed above")
            return self.k3_times[memo]
        dev = torch.device("cuda")
        gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        itemsize = torch.tensor([], dtype=dtype).element_size()
        cost = G.group_norm_cost(b, c, hh * ww, groups, itemsize, act, backward=True)

        def inputs():
            """x, dy, and the library's graph over a leaf copy of x (its
            backward reads what the forward saved)."""
            x, dy = (torch.randn((b, c, hh, ww), generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            xl, gl, bl = (t_.to(dtype).requires_grad_() for t_ in (x, gamma, beta))
            out = F.group_norm(xl, groups, gl, bl, eps)
            return x, dy, F.silu(out) if act else out, (xl, gl, bl)
        # every call finds x and dy out of L2 (the graphs' saved tensors too)
        call, copies = cold_ring(inputs, cost["bytes"])

        def kernel():
            return call(lambda x, dy, out, leaves: G.group_norm_bwd(x, gamma, beta, dy, groups,
                                                                    eps, act))
        kms, lms, krounds, lrounds = paired_ms(
            kernel, lambda: call(lambda x, dy, out, leaves: torch.autograd.grad(
                out, leaves, dy, retain_graph=True)), 10)
        warm = inputs()
        t = {"ms": kms, "events_ms": cuda_time(kernel, 10),
             "warm_ms": device_ms(lambda: G.group_norm_bwd(warm[0], gamma, beta, warm[1],
                                                           groups, eps, act), 10),
             "plain_ms": device_ms(lambda: call(
                 lambda x, dy, out, leaves: G._group_norm_bwd_ref(x, gamma, beta, dy, groups,
                                                                  eps, act)), 5),
             "library_ms": lms}
        t["bound_bytes_ms"] = cost["bytes"] / HBM_BYTES_PER_S * 1e3
        t["bound_ops_ms"] = cost["flops"] / PEAK_F32 * 1e3
        t["bound_ms"] = max(t["bound_bytes_ms"], t["bound_ops_ms"])
        bound_gate(f"K3 backward {(b, c, hh, ww)} G={groups} {str(dtype)[6:]}", t["bound_ms"],
                   t["ms"])
        path = path_name(G.kernel_path(dtype, c, hh * ww, groups, backward=True))
        log(f"  K3 backward {(b, c, hh, ww)} G={groups} act={act} {str(dtype)[6:]} {label} "
            f"({path}): kernel {t['ms']:.4f} (events {t['events_ms']:.4f}; warm "
            f"{t['warm_ms']:.4f}) | plain "
            f"{t['plain_ms']:.4f} | group_norm(+silu) backward {t['library_ms']:.4f} "
            f"({t['ms'] / t['library_ms']:.3f}x) | bound {t['bound_ms']:.4f} "
            f"({'bytes' if t['bound_bytes_ms'] >= t['bound_ops_ms'] else 'operations'}; "
            f"{cost['bytes'] / 1e6:.1f} MB; kernel at {100 * t['bound_ms'] / t['ms']:.1f}% "
            f"of it) | rounds kernel {[round(v, 4) for v in krounds]} library "
            f"{[round(v, 4) for v in lrounds]} | {copies} input copies in turn")
        self.k3_times[memo] = t
        return t

    def _timing_gn_bwd(self, gen, shapes, model_name):
        """K3's backward at a training step's shapes (``shapes``, the hooks'
        counts): the kernel, the plain version, the autograd backward of
        F.group_norm (+ F.silu), and the bytes bound of reading x and dy and
        writing dx; summed over the TRAIN_STEPS timed steps."""
        import torch

        tot = collections.Counter()
        log(f"  K3 backward at the {model_name}'s training shapes:")
        for key, count in sorted(shapes["group_norm_bwd"].items()):
            t = self._time_k3_bwd(gen, key, f"x{count}/step")
            for name, val in t.items():
                tot[name] += count * val * TRAIN_STEPS
                tot[f"step_{name}"] += count * val
        calls = sum(shapes["group_norm_bwd"].values())
        log(f"  K3 backward per {model_name} training step ({calls} calls, bf16; sum over "
            f"shapes): kernel "
            f"{tot['step_ms']:.3f} ms | plain {tot['step_plain_ms']:.3f} | group_norm(+silu) "
            f"backward {tot['step_library_ms']:.3f} "
            f"({tot['step_ms'] / tot['step_library_ms']:.3f}x) | bytes bound "
            f"{tot['step_bound_ms']:.3f}")
        torch.cuda.empty_cache()
        return tot

    # ----------------------------------------------------------------- profile
    def profile(self):
        """Device time of one DPM-20 request (batch 16, bf16), one guided
        layout request, one training step of each model (batch 16, bf16
        autocast), one LayoutDiffusion request (DDIM-100, f32), one
        LayoutDiffusion training step (16 scenes x 16 objects, f32) and one
        autoencoder training step (batch 4, f32) by kernel family, from
        torch.profiler, beside their wall times."""
        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from lidar_layout_tpu_torch.data.synthetic import synthetic_layouts
        from lidar_layout_tpu_torch.flagship import LAYOUT_YAML, flagship
        from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline
        from lidar_layout_tpu_torch.sample_layout import build_model, sample_layouts
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        model, _ = flagship(dtype=torch.bfloat16, device="cuda")
        seed_weights(model, 0)
        pipe = GenerationPipeline(model, KITTI_GEOMETRY)
        pipe.generate(BATCH, seed=1)                  # warm-up
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = pipe.generate(BATCH, seed=2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        self._families(prof, wall_ms, f"one DPM-20 request, batch {BATCH}, bf16 (host phases "
                                      f"{res.phase_seconds})")
        del model, pipe
        torch.cuda.empty_cache()

        pipe = GenerationPipeline.from_config(LAYOUT_YAML, dataset="32", bf16=True)
        seed_weights(pipe.model, 0)
        layouts = synthetic_layouts(np.random.default_rng(12), BATCH, pipe.geom)
        with torch.inference_mode():
            cond = pipe.model.get_learned_conditioning(layouts)
            uncond = pipe.model.get_learned_conditioning(np.zeros_like(layouts))
        kw = dict(batch=BATCH, cond=cond, uncond=uncond, cfg_scale=LAYOUT_CFG_SCALE)
        pipe.generate(BATCH, seed=1, **kw)            # warm-up
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = pipe.generate(BATCH, seed=2, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        self._families(prof, wall_ms, f"one guided layout request (DPM-20, cfg_scale "
                                      f"{LAYOUT_CFG_SCALE:g}), batch {BATCH}, bf16 (host "
                                      f"phases {res.phase_seconds})")
        del pipe, cond, uncond
        torch.cuda.empty_cache()

        gen = torch.Generator(device="cuda").manual_seed(0)
        for layout, title in ((False, "one training step"), (True, "one layout training step")):
            model, state = self._train_setup(OVERFIT_LR, layout)
            step = DT.make_train_step(model, autocast_dtype=torch.bfloat16)
            batch = self._train_batches(layout, 1)[0]
            for _ in range(2):                            # warm-up
                state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = step(state, batch, gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            self._families(prof, wall_ms, f"{title}, batch {TRAIN_BATCH}, bf16 autocast")
            del model, state
            gc.collect()
            torch.cuda.empty_cache()

        model = build_model(device="cuda")
        seed_weights(model, 0)
        graph = self._box_graph(11)
        sample_layouts(model, graph, BOX_STEPS, seed=1)   # warm-up
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sample_layouts(model, graph, BOX_STEPS, seed=2)
            wall_ms = (time.perf_counter() - t0) * 1e3
        self._families(prof, wall_ms, f"one LayoutDiffusion request ({BOX_SCENES} scenes x 16 "
                                      f"objects, DDIM-{BOX_STEPS}, f32)")
        del model
        torch.cuda.empty_cache()

        from lidar_layout_tpu_torch.train import layout_trainer as LT

        model, state = self._box_train_model()
        step = LT.make_layout_train_step(model)
        for _ in range(2):                                # warm-up
            state, _ = step(state, graph, gen)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, graph, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        self._families(prof, wall_ms, f"one LayoutDiffusion training step ({BOX_SCENES} scenes "
                                      f"x 16 objects, f32)")
        del model, state
        gc.collect()
        torch.cuda.empty_cache()

        from lidar_layout_tpu_torch.train import ae_trainer as AT

        model, disc, loss_cfg, geo, state = self._ae_setup()
        step = AT.make_ae_train_step(model, disc, loss_cfg, geo)
        batch = self._ae_batches(1)[0]
        for _ in range(2):                                # warm-up
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        self._families(prof, wall_ms, f"one autoencoder (VQ-GAN) training step, batch "
                                      f"{AE_BATCH}, f32, TF32 off")
        del model, disc, state
        gc.collect()
        torch.cuda.empty_cache()
        self._profile_ours(gen)
        self._profile_cond()
        self.profile_zoo()

    def profile_zoo(self):
        """profile's rows of the zoo, Sonata and conditional training: one
        forward and backward of each zoo backbone at its reference widths
        (one warm-up), one Sonata pre-training step and one step of each
        conditional LiDM (two warm-ups), under torch.profiler."""
        import torch
        import torch.nn.functional as F
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        def run(title, fn, warmups=2):
            for _ in range(warmups):
                fn()
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            self._families(prof, wall_ms, title)

        for name in ZOO_REFERENCE:
            model, cloud = self._zoo_model(name, False)
            coord, feat, mask = self._zoo_cloud(**cloud)
            labels = torch.randint(0, model.cfg.num_classes, (len(coord),), device="cuda")

            def fwd_bwd(model=model, coord=coord, feat=feat, mask=mask, labels=labels):
                model.zero_grad(set_to_none=True)
                F.cross_entropy(model(coord, feat, mask)[mask], labels[mask]).backward()
            run(f"zoo {name}: one forward and backward, {cloud['n']} rows, f32", fwd_bwd, 1)
            del model, coord, feat, mask, labels
            gc.collect()
            torch.cuda.empty_cache()
        model = self._sonata_model()
        step = model.make_pretrain_step(torch.optim.AdamW(model.student.parameters(),
                                                          lr=SONATA_LR, weight_decay=0.04))
        coord, feat, mask = self._zoo_cloud(SONATA_POINTS, SONATA_POINTS - ZOO_PAD, 4, "scene")
        gen = torch.Generator(device="cuda").manual_seed(0)
        run(f"one Sonata pre-training step, {SONATA_POINTS} rows, f32",
            lambda: step(coord, feat, mask, 0, gen))
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        for key in ("crossattn", "concat"):
            model = self._cond_train_model(key)
            params = DT.trainable_params(model)
            state = DT.create_train_state(model, DT.make_optimizer(params, COND_TRAIN_LR), params)
            train_step = DT.make_train_step(model)
            batch = self._cond_train_batches(key, 1)[0]
            run(f"one {key} LiDM training step, batch {COND_TRAIN_BATCH}, f32",
                lambda: train_step(state, batch, gen))
            del model, state, params
            gc.collect()
            torch.cuda.empty_cache()

    def _profile_ours(self, gen):
        """profile's rows of the "Ours" stages: one coarse DPM-20 request
        (batch 16, bf16), one coarse LiDM training step (batch 16, bf16
        autocast), one coarse AE step (batch 4, f32), one step of each cube
        trainer (4 clouds of 32,768 points, f32), one dense decode and one
        dense-decoder step (8192 points, f32), one Gaussian AE step (batch
        4, f32): two warm-ups, then one call under torch.profiler."""
        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
        from lidar_layout_tpu_torch.pipeline import GenerationPipeline
        from lidar_layout_tpu_torch.train import ae_trainer as AT
        from lidar_layout_tpu_torch.train import cube_trainer as CT
        from lidar_layout_tpu_torch.train import diffusion_trainer as DT

        def run(title, fn):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            self._families(prof, wall_ms, title)
            gc.collect()
            torch.cuda.empty_cache()

        pipe = GenerationPipeline.from_config(COARSE_LDM_YAML, bf16=True, device="cuda")
        seed_weights(pipe.model, 0)
        run(f"one coarse DPM-20 request, batch {BATCH}, bf16", lambda: pipe.generate(BATCH))
        del pipe
        model = self._coarse_ldm()
        params = DT.trainable_params(model)
        state = DT.create_train_state(model, DT.make_optimizer(params, COARSE_LR), params)
        step = DT.make_train_step(model, autocast_dtype=torch.bfloat16)
        batch = self._coarse_batches(1, TRAIN_BATCH)[0]
        run(f"one coarse LiDM training step, batch {TRAIN_BATCH}, bf16 autocast",
            lambda: step(state, batch, gen))
        del model, state, step
        model, disc, loss_cfg, geo, state = self._ae_setup(yaml_path=COARSE_AE_YAML,
                                                           accumulate=2)
        step = AT.make_ae_train_step(model, disc, loss_cfg, geo)
        batch = self._ae_batches(1, yaml_path=COARSE_AE_YAML)[0]
        run(f"one coarse AE training step, batch {AE_BATCH}, f32, TF32 off",
            lambda: step(state, batch, gen))
        del model, disc, state, step
        clouds = self._clouds(CUBE_BATCH, 30)
        for name, yaml_path in (("SparseVAE", VOXEL_YAML), ("CubeDiffusion", VOXEL_LDM_YAML)):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = instantiate_from_config(load_yaml(yaml_path)["model"]).to("cuda")
            state, step, _, _ = CT.cube_training(model, load_yaml(yaml_path)["model"], 1e-5)
            run(f"one {name} training step, {CUBE_BATCH} clouds of {CUBE_POINTS} points, f32",
                lambda: step(state, clouds, gen))
            del model, state, step
        del clouds
        from lidar_layout_tpu_torch.models.gs_decoder import render_surfels
        from lidar_layout_tpu_torch.ops.gaussian_raster import RasterConfig
        from lidar_layout_tpu_torch.train import train_dense_decoder as TD

        geom, rc = self._dense_geom(), RasterConfig(chunk=512)
        sample = self._dense_samples(1, 31)[0]
        model = self._dense_model()

        def decode():
            with torch.inference_mode():
                surfels = model(sample["points"], sample["feats"], sample["mask"])
                return render_surfels(surfels, geom, rc)
        run(f"one dense decode, {DENSE_POINTS} points, 32x1024, f32", decode)
        state = TD.create_dense_state(model, 2e-3, 5e-3)
        step = TD.make_dense_train_step(model, geom, rc)
        run(f"one dense-decoder training step, {DENSE_POINTS} points, f32",
            lambda: step(state, sample, None))
        del model, state, step
        model, disc, loss_cfg, geo, state = self._ae_setup(yaml_path=GAUS_AE_YAML, accumulate=2)
        step = ae_step(model, disc, loss_cfg, geo)
        batch = self._ae_batches(1, yaml_path=GAUS_AE_YAML)[0]
        run(f"one Gaussian AE training step, batch {AE_BATCH}, f32, TF32 off",
            lambda: step(state, batch, gen))
        del model, disc, state, step

    def _profile_cond(self):
        """profile's rows of conditional generation: one request of each CLI
        model (map2lidar and cam2lidar, 4 samples; text2lidar, 2 samples at
        cfg_scale 2.0; DDIM-50, f32, seeded as _seed_cond), after one warm-up,
        under torch.profiler."""
        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from lidar_layout_tpu_torch import sample_cond, text2lidar
        from lidar_layout_tpu_torch.encoders.modules import simple_tokenize

        for task, n in (("map2lidar", 4), ("cam2lidar", 4), ("text2lidar", 2)):
            if task == "text2lidar":
                model = text2lidar.build_text_model()
                args = ("c_crossattn", np.tile(simple_tokenize(["a busy intersection"]), (n, 1)),
                        n, COND_STEPS, simple_tokenize([""] * n), COND_CFG_SCALE)
            else:
                model = sample_cond.build_task_model(task)
                args = ("c_concat" if task == "map2lidar" else "c_crossattn",
                        sample_cond.synthetic_conditions(task, n), n, COND_STEPS)
            self._seed_cond(model)
            sample_cond.sample(model, *args)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sample_cond.sample(model, *args)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            self._families(prof, wall_ms, f"one {task} request, {n} samples, DDIM-{COND_STEPS}, "
                           f"f32{', cfg_scale 2' if task == 'text2lidar' else ''}")
            del model
            gc.collect()
            torch.cuda.empty_cache()

    @staticmethod
    def _families(prof, wall_ms, title):
        from torch.autograd import DeviceType

        families = (("K1 flash_attention", ("attn_fwd",)),
                    ("K2 flash_attention_bwd", ("bwd_bf16", "bwd_dkdv", "bwd_dq", "bwd_delta")),
                    ("K3 group_norm forward", ("group_norm_fwd",)),
                    ("K3 group_norm backward", ("group_norm_bwd", "group_norm_param")),
                    ("optimizer and EMA (foreach)", ("multi_tensor", "foreach")),
                    ("convolution / matmul (cuDNN, cuBLAS)",
                     ("conv", "xmma", "gemm", "cudnn", "cutlass", "sm90", "implicit",
                      "wgrad", "dgrad")),
                    ("elementwise / copy / reduce (PyTorch)",
                     ("elementwise", "vectorized", "reduce", "copy", "cat", "fill",
                      "upsample", "index", "pool", "softmax")))
        by_family, kernels = collections.Counter(), []
        for ev in prof.key_averages():
            # user annotations (e.g. Optimizer.step) span kernels counted already
            if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
                continue
            us = ev.self_device_time_total
            kernels.append((us, ev.count, ev.key))
            name = ev.key.lower()
            family = next((f for f, keys in families if any(k in name for k in keys)), "other")
            by_family[family] += us
        busy_ms = sum(by_family.values()) / 1e3
        log(f"profile: {title}: wall {wall_ms:.1f} ms (profiler on), device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall) in "
            f"{sum(k[1] for k in kernels)} device activities")
        if busy_ms == 0:
            log("  the profiler saw no device time")
            return
        for family, us in by_family.most_common():
            log(f"  {family}: {us / 1e3:.2f} ms ({100 * us / 1e3 / busy_ms:.1f}% of device time)")
        for us, count, key in sorted(kernels, reverse=True)[:12]:
            log(f"    {us / 1e3:9.2f} ms  x{count:<5d} {key[:110]}")

    def summary(self):
        """The kernels line: ``launches`` and the times cover the run each
        kernel serves, the DPM-20 main run for K1/K3, the timed training
        steps for K2 and K3's backward, and the eval's CD for K4;
        ``train_launches`` counts every kernel over those steps;
        ``layout_launches`` over the guided layout run, and the ``layout_*``
        times K3's over that run; ``layout_train_launches`` over the layout
        model's timed training steps and ``layout_boxes_launches`` over one
        LayoutDiffusion request, with ``layout_train_*`` the times of K3's
        backward over those steps and ``layout_boxes_*`` K1's over that
        request; ``layout_boxes_train_launches`` over LayoutDiffusion's timed
        training steps, with ``layout_boxes_train_*`` the times of K1 (with
        its log-sum-exp) and K2 over those steps; ``split_*`` over the
        patched 64x2048 DPM-20 run and ``ae_bf16_train_*`` over the bf16
        AE's timed steps."""
        entries = []
        # the sp kernels' launches are a rank's over the sp phase's sharded
        # encode and apply_model, and their times summed over it
        for name, source, replaces in KERNELS:
            tot = getattr(self, "totals", {}).get(name, {})
            bound_by = ("operations" if tot.get("bound_ops_ms", 0) >= tot.get("bound_bytes_ms", 0)
                        else "bytes")
            trained = name in ("flash_attention_bwd", "group_norm_bwd")
            launches = (self.train_launches if trained else
                        self.eval_launches if name == "chamfer_nn" else
                        self.sp_launches if name in sp_counters() else self.launches).get(name)
            entries.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "train_launches": self.train_launches.get(name),
                "max_abs_err": self.kernel_err[name],
                "ms": tot.get("ms"), "plain_ms": tot.get("plain_ms"),
                "bound_ms": tot.get("bound_ms"), "bound_by": bound_by,
                "library_ms": tot.get("library_ms"), "warm_ms": tot.get("warm_ms"),
                "layout_launches": self.layout_launches.get(name),
                "layout_boxes_max_abs_err": (self.kernel_err.get("flash_attention_boxes")
                                             if name == "flash_attention" else None),
                "layout_train_launches": self.layout_train_launches.get(name),
                "layout_boxes_launches": self.layout_boxes_launches.get(name),
                "layout_boxes_train_launches": self.layout_boxes_train_launches.get(name),
                "layout_boxes_train_max_abs_err": (
                    self.kernel_err.get("flash_attention_bwd_boxes")
                    if name == "flash_attention_bwd" else None),
                "ae_train_launches": self.ae_train_launches.get(name),
                "ae_train_max_abs_err": self.kernel_err.get(f"ae_{name}"),
                "coarse_launches": self.coarse_launches.get(name),
                "coarse_train_launches": self.coarse_train_launches.get(name),
                "coarse_ae_train_launches": self.coarse_ae_train_launches.get(name),
                "coarse_max_abs_err": self.kernel_err.get(f"coarse_{name}"),
                "ae_eval_launches": self.ae_eval_launches.get(name),
                "cube_launches": self.cube_launches.get(name),
                "dense_launches": self.dense_launches.get(name),
                "dense_train_launches": self.dense_train_launches.get(name),
                "gaus_ae_train_launches": self.gaus_ae_train_launches.get(name),
                "dense_max_abs_err": self.kernel_err.get(f"dense_{name}"),
                "gaus_ae_train_max_abs_err": self.kernel_err.get(f"gaus_ae_{name}"),
                "cond_launches": self.cond_launches.get(name),
                "cond_max_abs_err": self.kernel_err.get(f"cond_{name}"),
                **{f"{run}_launches": self.families_launches.get(run, {}).get(name)
                   for run in ("r2dm_request", "r2dm_train", "g2sd_train", "kl_train",
                               "recon_tester")},
                "r2dm_max_abs_err": self.kernel_err.get(f"r2dm_{name}"),
                "split_launches": self.split_launches.get(name),
                "split_max_abs_err": self.kernel_err.get(f"split_{name}"),
                "ae_bf16_train_launches": self.ae_bf16_launches.get(name),
                "ae_bf16_max_abs_err": self.kernel_err.get(f"ae_bf16_{name}"),
                "sonata_train_launches": self.sonata_launches.get(name),
                "sonata_max_abs_err": self.kernel_err.get(f"sonata_{name}"),
                **{f"cond_train_{key}_launches": self.cond_train_launches.get(key, {}).get(name)
                   for key in ("crossattn", "concat")},
                "cond_train_max_abs_err": self.kernel_err.get(f"cond_train_{name}"),
                "ddp_rank_launches": self.ddp_launches.get(name),
                **({"sp_encode_max_abs_err": self.kernel_err.get("sp_encode"),
                    "sp_apply_model_max_abs_err": self.kernel_err.get("sp_apply_model")}
                   if name in sp_counters() else {}),
                **{f"{run}_{k}": self.run_totals.get(name, {}).get(run, {}).get(k)
                   for run in ("layout", "layout_train", "layout_boxes", "layout_boxes_train",
                               "ae_train", "coarse", "coarse_train", "coarse_ae_train",
                               "dense", "dense_train", "gaus_ae_train", "ae_eval", "cond",
                               "r2dm_request", "r2dm_train", "split", "ae_bf16_train",
                               "sonata", "cond_train")
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms", "warm_ms")}})
        return {"kernels": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    try:
        import lidar_layout_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 2

    smoke = Smoke()
    t_all = time.perf_counter()
    try:
        for phase in PHASES + EXTRA_PHASES:
            if phase not in phases and phase not in ("device", "build"):
                continue
            t0 = time.perf_counter()
            log(f"=== phase {phase}")
            getattr(smoke, phase)()
            log(f"=== phase {phase} done in {time.perf_counter() - t0:.1f} s")
    finally:
        smoke.cleanup()
    log(f"all phases: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(smoke.summary()))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
