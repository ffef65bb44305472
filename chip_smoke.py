#!/usr/bin/env python3
"""Drive the PyTorch port (``concepthash_tpu_torch``) on one NVIDIA GPU and
check every kernel of its serving and training paths. Run from the root of
the repository:

    python3 chip_smoke.py

It needs a CUDA device and exits non-zero without one, or on any failed
check; it imports nothing of JAX or of the JAX package. Phases:

1. the card's name and power limit; the five CUDA sources built from
   ``concepthash_tpu_torch/csrc`` (one nvcc each, started together);
2. the encoder-layer kernel against its plain version at ViT-B/32 width
   (B=8, L=54, D=768, F=3072, 12 heads, quick_gelu, bf16), with both
   adapters (bottleneck 384) and without, at the flagship's eval batch
   B=32 and its database tail B=16 with both, and at the timed batch B=256
   (M = 13,824 rows) with both;
3. the subblock-min kernel against its plain version, exactly, in the
   serving layout (the (Q, m_pad) mins with their pad columns at nbit + 1
   and the superblock mins): 1024 queries over 1,000,003 codes, S=64, nbit
   64 packed (bf16 and f32) and plain, nbit 32 and 16 packed, nbit 128
   plain; the plain layout also through ``subblock_min_dists``, the
   reference's (m, Q) view;
4. the serving slice, counted: the canonical ConceptHash (ViT-B/32, adapters
   384, 4 concepts, 64 bits, 200 classes, random weights from seed 0, bf16)
   encodes 256 seeded uint8 images; their codes are planted at known rows of a
   1,048,576-entry seeded +-1 gallery, packed with ``pack_serving_gallery``
   and ``pack_bits_serving``, and served by ``retrieve_topk(exact=True)`` and
   ``retrieve_topk_streaming(exact=True)`` with the bit-pack given, over the
   packed layout (kernel 2's route) and over the plain (N, 64) one (kernel
   3's), at k=100. Checked: each
   planted row comes back at distance 0; the distances equal those of a
   plain full-matrix top-k on the card; the codes agree in sign with a
   plain encode (every layer through the kernel's plain version) on >= 99%
   of bits; each kernel was launched (12 layer launches per encode); then
   the same weights at compute dtype float32 (the flagship config's) encode
   the 256 images on the card (the discrete path: the layer kernel takes
   bf16 only) and the first 64 on the CPU, and their codes agree in sign
   on >= 99% of bits with each other and with the bf16 codes;
5. timings on the card: encode img/s, int8 serving queries/s through
   ``retrieve_topk`` (which packs the gallery on every call) and through
   ``retrieve_topk_streaming`` over the gallery packed once, each kernel's
   time beside its bound, its plain version and a PyTorch yardstick
   (kernel 2 also beside kernel 4 at the same N and S), the host
   microseconds to issue one layer call, and one traced encode and two
   traced serving calls (torch.profiler): device time by kernel and by
   operator with shapes, the device's busy share, and kernel 1's device
   time split into its GEMMs, its attention and its LayerNorm passes;
6. the LayerNorm -> matmul kernel against its plain version at N = 1,728
   (32 images x 54 tokens), N = 1,000 (a tail) and N = 13,824 (the B=256
   train step), D = 768, F = 2,304 (q|k|v) and 3,072 (fc1), bf16; the
   attention kernel against its plain
   version at B = 32, H = 12, hd = 64, L = 54 and 197 (ViT-B/16's length),
   reading q, k, v in place from one q|k|v tensor;
7. the train slice, counted: the canonical ConceptHash (the config dicts of
   configs/model/concepthash.yaml: adam at lr 1e-3, weight decay 1e-5, csw,
   frozen backbone, dropout 0.1) in bf16 with random weights from seed 0,
   ``attention_impl="pallas"``, ``fused_ln="pallas"``, seeded (200, 512)
   centers, 32 seeded uint8 images center-cropped and normalized, seeded
   labels; five steps on that batch, each drawing the same dropout masks.
   Checked: 24 LayerNorm -> matmul and 12 attention launches per step; a
   finite loss every step and a lower one at step 5 than at step 1; the
   frozen parameters bit-unchanged; then one step with the kernels against
   one step with their plain versions from the same state: loss within 2%,
   each trained tensor's update at cosine >= 0.99;
8. train timings: img/s at batch 32 and 256 with the kernels and with the
   'xla' configuration, kernels 5 and 6 beside bound, plain version and
   yardstick (kernel 6 also at N = 13,824, and the host microseconds per
   call; kernel 5 also at B = 256 beside SDPA), and one traced train step;
9. the bit-plane mins kernel against its plain version, exactly, in the
   serving layout (the (Q, m_pad) mins with their pad columns at nbit + 1
   and the superblock mins): 1024 queries over 1,000,003 codes at nbit 64
   and 32, bf16 and f32, S=128, ``n_rows`` masking the byte-pad rows while
   the pack-pad slots stay in;
10. the bit-plane serving slice, counted: a gallery of 10^8 seeded 64-bit
   codes born bit-plane (6,250,000 random byte rows, 800 MB) with phase 4's
   256 codes planted by unpacking, editing and repacking their byte rows,
   served by ``exact_topk_bitplane(k=100, n_valid=N)`` at S=128 (the
   hierarchical selection over 781,250 subblock mins). Checked: the
   certificate holds; each planted row comes back at distance 0; the
   distances equal those of a plain walk over the unpacked gallery (full
   distances and an exact top-k per 2^22-code block, merged), and the
   kernel's (781,250, 256) mins at the path's own arguments equal that
   walk's subblock mins; the indices score their distances, read from the
   bytes; the kernel was launched. Timed: queries/s, the kernel at the
   serving point (the JSON numbers) with its bound, plain version and a
   yardstick (``unpack_bitplane`` + ``torch._int_mm`` + amax, both in
   2^22-code blocks), the same at Q=256, N=2^20 (S=64, beside kernel 2),
   and one traced call;
11. ``exact=False``: ``retrieve_topk`` and ``retrieve_topk_streaming`` over
   phase 4's 2^20 gallery at k=100 beside the exact path (the other option
   for it): queries/s and distance-level recall@100 against the exact
   answer (>= 0.95), indices scoring their distances;
12. scoring: ``calculate_mAP`` (R=-1 and R=[10, 100], PRs 1, 5, 10) and
   ``calculate_pr_curve`` on the card, over the 256 encoded codes as
   queries and 4,096 seeded labelled codes as database, equal to the same
   calls on the CPU within 1e-5; then both timed on the card at the size
   of a CUB-200 eval (5,794 queries, 5,994 database codes, seeded);
13. the CLIP text tower at ViT-B/32's text geometry (random weights from a
   seed, 200 seeded prompts of 77 ids, an eos in each) at float32 on the
   card against the same tower on the CPU, within ``TEXT_ATOL``; the same
   run with TF32 matmuls is printed beside it, the slip the limit must
   catch;
14. ``main_gpu``'s flagship run in-process (dataset=cub200
   model=concepthash compute_dtype=bfloat16, 2 epochs, an evaluation after
   each, ``train_chunk=1``: one step a dispatch) on a synthetic set of 200
   classes (2 train + 1 test images a class, 256^2) written by the port's
   maker, with the launch counts from zero. Checked: the run directory, two finite train records with ``lr``
   equal to ``current_lr``, two test records, the (200, 512)
   offline-fallback codebook and its warning, kernel 1 at 12 launches an
   eval batch and no other kernel, the eval codes of the test and database
   splits against an encode through the kernel's plain version (>= 99%
   sign agreement), and ``models/last.pt`` reloaded into a fresh
   experiment encoding the test split to the same codes bit for bit; then
   timings, an epoch's parts and a traced train epoch;
15. several steps per dispatch (CUDA graphs) at ViT-B/32 full width and
   depth: (a) 2 x 8 train steps at B=32 (dropout 0) through
   ``make_multi_train_step`` (a warm-up chunk, then a replay) against 16
   eager steps from the same state (the optimizer a ``train_chunk=1`` run
   builds), per-step losses and the parameters bit for bit, the per-step
   ``lr`` equal to ``current_lr``; again with
   ``attention_impl="pallas"``, ``fused_ln="pallas"``, kernels 5 and 6
   counted per replay, and again with sgd (momentum, weight decay); with
   dropout 0.1, three chunks on the same batches:
   the generator advances, the loss is finite and falls, an eager twin
   printed beside it; (b) the multi eval step's codes at B=32 equal the
   eager eval step's bit for bit, kernel 1 at 96 launches a replay; (c) the
   flagship run at ``train_chunk=auto`` (8) with ``save_training_state``
   on phase 14's set (200 classes x 2 train images: 12 steps an epoch, a
   chunk of 8 and 4 single steps), counted: kernel 1 at 12 launches an
   eval batch, replays included; ``exp=validation use_last=true`` reproduces the run's last
   mAP within 1e-6, ``exp=extract`` writes the run's best test codes bit
   for bit, a run stopped after epoch 1 and resumed reaches the epoch-2
   train loss and the last parameters bit for bit; a ``train_chunk=1`` run
   on the same set and seed reaches both epochs' losses and
   ``models/last.pt`` bit for bit (one optimizer arithmetic for every
   step), its train img/s printed beside, and with the device's busy share
   beside phase 14's; (d) random vision and text towers written as a local Hugging
   Face CLIP checkpoint (``config.json``, ``pytorch_model.bin``, a synthetic
   ``vocab.json`` and ``merges.txt``): the flagship built with
   ``backbone.name=<dir>`` holds the written vision tower bit for bit and
   encodes 256 images to the source model's codes, and its codebook comes
   from the real text stage on the card, within ``TEXT_ATOL`` of the CPU's;
16. the other ConceptHash models and options at full width: (a) one model
   per option (SelfAttentionAtLast as configs/model/concepthash_sa.yaml has
   it, and with cross_attention, strong, differentiable and add_pe;
   ``add_bn: dbn``; ``vpt_pe``; ``use_before_projection: false``; q/k/v/out
   adapters; FILIP with seeded token embeddings), bf16 with seeded weights,
   encodes 64 seeded images on the card, counted: codes agree in sign with
   the same weights' f32 encode on the CPU on >= 99% of bits, kernel 1 at
   12 launches an encode (none with q/k/v/out adapters); (b) five train
   steps of SA + DBN, FILIP, vpt_pe with ``backbone.remat`` and q/k/v/out
   adapters at ``attention_impl="pallas"``, ``fused_ln="pallas"``, counted
   per step (kernels 5 and 6 at 12 and 24, q/k/v/out adapters 12 and 0,
   remat twice that: the checkpointed forward runs again in the backward),
   the loss finite and falling; a remat step against a stored-activation
   step, and graphed chunks (K=4) of SA + DBN, FILIP and lars against eager
   steps, bit for bit; (c) after phase 15, on its synthetic set:
   ``main_gpu.py model=concepthash_sa`` and ``model=concepthash_filip``
   (FILIP's class-text token embeddings from phase 15 (d)'s local
   checkpoint, within ``TEXT_ATOL`` of the CPU's) at ``train_chunk=auto``,
   2 epochs, counted (kernel 1 at 12 launches an eval batch), each with
   ``exp=validation``, ``exp=extract`` and a resume checked as phase 15
   (c) checks them, their epoch-2 train and eval img/s printed beside the
   chunked flagship's;
17. the supervised baselines on the CLIP-adapter trunk (the config dicts
   of their configs/model/*.yaml at ViT-B/32, adapters 384, 64 bits, 200
   classes, bf16, seeded weights; descriptor as ce_adapter's with no
   objective): (a) one seeded trunk shared by the 11 heads (orthohash,
   orthohash_bcs, csq, dpn, hashnet, dpsh, dtsh, greedyhash, ce,
   descriptor, clip) encodes 64 seeded images on the card, counted
   (kernel 1 at 12 launches an encode, no other kernel), against the same
   weights at float32 on the CPU, whose trunk runs once: codes agree in
   sign on >= 99% of bits, descriptor's and clip's features at mean row
   cosine >= 0.99, orthohash's, ce's and clip's logits within
   ``LOGIT_RTOL`` of the largest; (b) five eager train steps of each at
   B=32 at the kernel settings, counted (kernels 5 and 6 at 12 and 24 a
   step), the loss finite and falling (descriptor: zero, its adapters
   unchanged at weight decay 0), the frozen backbone bit-unchanged,
   hashnet's ``keep_train_size`` bank equal to its batch's detached
   tanh(beta * codes), and for every method but hashnet a graphed chunk
   (a warm-up and a replay of 4) against eager steps bit for bit; (c)
   after phase 16 (c), on phase 15's synthetic set: ``main_gpu.py
   model=orthohash_adapter``, ``model=hashnet_adapter`` (one step a
   dispatch) and ``model=clip_finetune`` (vision tower and class-text
   centers from phase 15 (d)'s local checkpoint) at ``train_chunk=auto``,
   2 epochs, counted, each with ``exp=validation`` within 1e-6 of its last
   mAP, their epoch-2 train and eval img/s printed beside the chunked
   flagship's;
18. the fine-grained heads, the adsh regime, the autoencoder binarizers
   and the loader (the config dicts of configs/model/a2net_ce_adapter,
   semicon_ce_adapter, semicon and adsh .yaml at ViT-B/32, adapters 384,
   4 maps, 64 bits, 200 classes, bf16, seeded weights): (a) one seeded
   trunk shared by the four heads encodes 64 seeded images on the card,
   counted (kernel 1 at 12 launches an encode, no other kernel), against
   the same weights at float32 on the CPU: codes agree in sign on >= 99%
   of bits, A2NetCE's and SemiconCE's logits within ``LOGIT_RTOL``; (b)
   five eager train steps each of a2net_ce, semicon_ce and adsh (against
   an 800-row V) at B=32 at the kernel settings, counted (kernels 5 and 6
   at 12 and 24 a step), the loss finite and falling (a2net_ce: its loss
   and gradients against their plain versions'), the frozen backbone
   bit-unchanged, graphed chunks of the two CE heads bit for bit;
   ``solve_dcc`` at CUB-200's size on the card against the CPU (>= 99.9%
   of entries equal) and timed; ``ae_fit`` (``ae``,
   ``induced_ae_norm_cossim``) on a (200, 512) embedding, 1,000 and 200
   iterations card against CPU (signs on >= 99%), then ``ae``'s 10,000 on
   the card, timed; (c) after phase 17 (c), on phase 15's synthetic set:
   ``main_gpu.py model=a2net_ce_adapter`` and ``model=semicon_ce_adapter``
   at ``train_chunk`` auto with ``exp=validation`` (semicon_ce at the
   run's batch size: its mask is batch-global) within 1e-6 of the last
   mAP, and ``model=semicon`` (the adsh regime, one step a dispatch):
   finite losses, a +-1 (400, 64) ``outputs/db_codes.pt``, a mAP
   in [0, 1], counted (kernel 1 in every eval batch), img/s beside the
   chunked flagship's; (d) the loader alone on phase 15's 400 train PNGs,
   PIL against ``native_decode`` (the native route required where the
   library builds; where it cannot, every image to PIL with the WARNING),
   then the chunked flagship again with ``cache_images=true`` (epoch
   losses and ``models/last.pt`` bit for bit the default run's) and, where
   the library builds, ``native_decode=true``: epoch-2 train img/s and
   the busy share beside the default run's.
19. the unsupervised methods and the shallow regime (the config dicts of
   configs/model/cibhash, bihalf, nsh, ssdh and itq .yaml at ViT-B/32,
   adapters 384 (itq: none), 64 bits, 200 classes, bf16, seeded weights;
   unsup_greedyhash as cibhash's with its own loss): (a) the five heads on
   one seeded trunk and itq's descriptor on one without adapters encode 64
   seeded images on the card, counted (kernel 1 at 12 launches an encode,
   no other kernel), against the same weights at float32 on the CPU:
   codes agree in sign on >= 99% of bits, nsh's latents and the
   descriptor's features at mean row cosine >= 0.99; (b) five eager train
   steps each of cibhash, bihalf, nsh (two views, 2B = 64 image rows),
   ssdh (its batch's structure from its own eval codes as ``aux``) and
   unsup_greedyhash at B=32 at the kernel settings, counted (kernels 5
   and 6 at 12 and 24 a step), the loss finite and, for cibhash, nsh and
   ssdh, falling, the frozen backbone bit-unchanged, a kernel step against
   a plain step under sgd (loss within 2%, the update's cosine over all
   trained tensors >= 0.99; adam's printed; cibhash and bihalf, whose
   losses take straight-through signs that one rounding moves: the
   backward of one loss gradient through both, at the same limits);
   graphed chunks
   (a warm-up and a replay of 4) of cibhash (two views) and ssdh (a
   staged (K, B, B) ``aux``) against eager steps, bit for bit;
   ``ssdh_structure`` and the four shallow fits timed at CUB-200's size
   (5,994 rows: 64-wide codes, 768-wide features); (c) after phase 18
   (d), on phase 15's synthetic set: ``main_gpu.py model=cibhash`` and
   ``model=ssdh`` at ``train_chunk=auto``, 2 epochs, counted (kernel 1
   in every eval batch and SSDH's structure encode), ``exp=validation``
   within 1e-6 of the last mAP, SSDH's structure shares printed; then
   ``model=itq`` (the shallow regime): kernel 1 at 12 launches in every
   fit-extraction and eval batch, one test record with a mAP in [0, 1],
   the fit in ``models/best.pt``, ``exp=validation`` raising its
   ValueError, and the whole run's img/s.
20. the pretraining methods, TBH and the odc regime: (a) after phase 19
   (b), the heads of moco, dino, tbh and odc on one seeded trunk with
   adapters, and the MAE net of mae and autoencoder (ViT-B/16 at 224^2,
   one seed), each encode 64 images in bf16, counted (kernel 1 once a
   layer), against the CPU's f32 (tbh's and odc's codes in sign on >= 99%
   of bits, the projections and the MAE's features at cosine >= 0.99);
   kernel 1 against its plain version at the MAE's shape (B=64, L=196,
   D=768, exact GELU, no adapters), timed; (b) five counted steps of each
   at B=32 (mae and autoencoder at their config's 64) at the kernel
   settings for the trunk's four (kernels 5 and 6 at 48 and 96 a step for
   moco and dino, 12 and 24 for tbh and odc), a kernel step against a
   plain one under sgd, the teacher's EMA at each step's momentum, DINO's
   center, TBH's discriminator under its own Adam, ODC's memory rows
   outside the batch and its refresh boundary; the MAE's graphed chunk
   (its mask drawn inside the graph) against eager steps bit for bit,
   the generator's state included; the port's k-means at CUB-200's size
   on the card against the CPU; (c) after phase 19 (c), on
   phase 15's synthetic set: ``main_gpu.py model=moco`` (and a resume
   after epoch 1, bit for bit) and ``model=mae`` (``exp=general``), then
   ``model=tbh`` and ``model=odc`` (its k-means encode counted, its NMI
   checked) with ``exp=validation`` within 1e-6, their img/s beside the
   flagship's.
21. the non-CLIP trunks (``configs/backbone/``'s groups under
   configs/model/orthohash_adapter.yaml's head: 64 bits, 200 classes,
   adapters 384 on the vit towers, bf16, seeded weights): (a) after phase
   20 (b), resnet18 (frozen_bn), resnet50, resnet101, swin_tiny,
   swin_base, alexnet, vgg16, vit_s16 and vit_b16, and a2net_ce on
   resnet50's grid, each encode 64 seeded images at 224^2 on the card,
   counted (kernel 1 at 12 launches a vit encode, none otherwise), against
   the same weights at f32 on the CPU (the first 16 images): codes in sign
   on >= 99% of bits, features at cosine >= 0.99, logits within 5% of the
   largest; kernel 1 against its plain version at the two vit shapes
   (B=64, L=197, D=384 and 768, exact GELU, both adapters), timed beside
   F.linear + SDPA; (b) five counted steps at B=32 of resnet18, resnet50,
   vgg16, vit_b16 (kernels 5 and 6 at 24 + 12 a step) and swin_base, the
   loss finite and (but vgg16's, under dropout) falling: resnet50's
   first-step running statistics against 0.9 r + 0.1 (batch mean, biased
   variance) within 1e-5 and ``num_batches_tracked`` counting steps,
   resnet18's frozen buffers bit-unchanged, vgg16's dropout replayed from
   the run's generator, vit_b16's kernel step against a plain one under
   sgd; graphed chunks of 4 of resnet50, vgg16 and vit_b16 against eager
   steps bit for bit, buffers and the generator included; (c) after phase
   20 (c), on phase 15's set: ``main_gpu.py model=orthohash_adapter
   backbone=resnet50`` (with a resume bit for bit) and ``csq_adapter
   backbone=swin_base`` at ``train_chunk=auto``, ``exp=validation`` at the
   run's batch within 1e-6; ``dpsh_adapter backbone=vit_b16`` at
   ``train_chunk=1`` with ``profile`` over the first evaluation (the trace
   names kernel 1's kernels) and its first epoch again under
   ``debug.disable_jit`` bit for bit; (d) a seeded orthohash-on-resnet50
   state renamed into the reference's layout, through
   ``scripts/import_reference_checkpoint_torch.py`` and
   ``exp=validation``: the imported state and test codes equal the seeded
   model's bit for bit.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
INT8_PEAK = 1979e12     # H100 SXM dense int8 tensor-core OP/s
HBM_RATE = 3.35e12      # H100 SXM device-memory bytes/s

# kernel 1 vs its plain version: |got - ref| <= LAYER_ATOL + LAYER_RTOL*|ref|
# (both round to bf16 at the same points; f32 sums in another order can put
# an intermediate on the neighbouring bf16 value, a few ulps at the output)
LAYER_ATOL, LAYER_RTOL = 0.05, 0.02
MIN_SIGN_AGREEMENT = 0.99
# exact=False: least distance-level recall@k against the exact top-k (the
# reference's approx_min_k recall_target)
MIN_APPROX_RECALL = 0.95
# scoring on the card vs the CPU: f32 sums in another order
SCORING_ATOL = 1e-5
# kernels 5 and 6 vs their plain versions: |got - ref| <= atol + rtol*|ref|
# (LN -> matmul: both round x_hat*gamma+beta and the output to bf16 at the
# same points; attention: f32 inside, one bf16 rounding at the output; f32
# sums in another order can put a value on the neighbouring bf16 number)
LN_ATOL, LN_RTOL = 0.02, 0.02
ATTN_ATOL, ATTN_RTOL = 0.01, 0.01
# one train step with the kernels vs one with their plain versions
TRAIN_LOSS_RTOL = 0.02
MIN_UPDATE_COSINE = 0.99
# Trained parameters whose gradient is zero in exact arithmetic (the
# hash-query softmax is invariant to the key bias, the train-mode code
# BatchNorm to hash_pe): adam turns their rounding noise into updates that
# no two runs share, so their cosines are printed, not held.
NULL_GRADIENT = ("hash_attention.sa.key.bias", "hash_pe")
# the CLIP text tower at float32 on the card vs the CPU (TF32 off): f32
# sums in another order through 12 layers, on values of order 1. Set
# between the two readings on an H100 (PERF.md §6): 7.03e-06 at
# float32, 3.64e-03 with TF32 matmuls, the slip this limit must catch.
TEXT_ATOL = 1e-4
# the eval-only run against the run's own last evaluation
REPLAY_MAP_ATOL = 1e-6
TRAIN_VISION = dict(attention_impl="pallas", fused_ln="pallas")
XLA_VISION = dict(attention_impl="xla", fused_ln="xla")
# phase 21 (a)'s trunks, (b)'s trained ones and those of them held graphed
TRUNK_GROUPS = ("resnet18", "resnet50", "resnet101", "swin_tiny", "swin_base",
                "alexnet", "vgg16", "vit_s16", "vit_b16")
TRUNK_TRAINED = ("resnet18", "resnet50", "vgg16", "vit_b16", "swin_base")
TRUNK_GRAPHED = ("resnet50", "vgg16", "vit_b16")
# configs/optim/sgd.yaml with nesterov: phase 15 graphs sgd's step too
SGD_OPTIM = {"name": "sgd", "lr": 0.001, "momentum": 0.9,
             "weight_decay": 0.0005, "nesterov": True}


@dataclasses.dataclass(frozen=True)
class Sizes:
    vision: dict = dataclasses.field(default_factory=dict)   # ViT-B/32
    head: dict = dataclasses.field(default_factory=lambda: dict(
        nbit=64, nclass=200, text_projection_dims=(512,)))
    bottleneck: int = 384
    layer_batch: int = 8           # images in the layer check
    layer_batch_big: int = 256     # and the timed batch (M = 13,824)
    layer_batches_eval: tuple = (32, 16)   # the flagship's eval batch, tail
    mins_queries: int = 1024
    mins_codes: int = 1_000_003
    images: int = 256
    f32_cpu_images: int = 64       # phase 4's f32 CPU reference, the first
    image_side: int = 256          # center-cropped to the model's size
    gallery: int = 1 << 20
    k: int = 100
    reps: int = 10
    ln_rows: tuple = (32 * 54, 1000)   # LN -> matmul check: N, and a tail
    ln_rows_big: int = 256 * 54        # the B=256 train step's N
    attn_batch: int = 32
    attn_lengths: tuple = (54, 197)    # ViT-B/32 + 4 concepts; ViT-B/16
    train_batch: int = 32              # the flagship's batch
    train_batch_big: int = 256
    train_steps: int = 5
    steps_per_epoch: int = 188         # CUB-200: 5,994 train images / 32
    bitplane_codes: int = 100_000_000  # bench.py's serving_exact_100m point
    bitplane_subblock: int = 128       # exact_topk_bitplane's default
    walk_codes: int = 1 << 22          # codes per block of the plain walk
    scoring_db: int = 4096             # labelled database codes, phase 12
    scoring_split: tuple = (5794, 5994)  # CUB-200 test x train: timed only
    text: dict = dataclasses.field(default_factory=dict)   # CLIP B/32 text
    prompts: int = 200                 # one per CUB-200 class, phase 13
    flagship_classes: int = 200        # CUB-200's count, phase 14
    flagship_per_class: tuple = (2, 1)  # train, test images a class
    flagship_image: int = 256          # written at dataset.resize square
    flagship_args: tuple = ()          # overrides after the flagship's own
    graph_chunk: int = 8               # train_chunk 'auto' on the card
    # phases 16 (b)-19 (b): steps a chunk in the graph-vs-eager checks
    check_chunk: int = 4
    # phases 15 (c) to 20 (c): 12 steps of 32 an epoch (a chunk of 8 and 4
    # single steps; mae's 6 of 64 are single), phase 14's set
    graph_per_class: tuple = (2, 1)
    hf_text: dict = dataclasses.field(default_factory=dict)  # CLIP B/32 text
    pretrained_images: int = 256
    variant_images: int = 64           # phase 16 (a): each option's encode
    filip_tokens: int = 8              # phase 16 (a), (b): seeded tokens
    adsh_db: int = 800                 # phase 18 (b): stored codes V's rows
    dcc_split: tuple = (5994, 2000)    # CUB-200's train rows, num_samples
    ae_embedding: tuple = (200, 512)   # classes x CLIP text width
    # card vs CPU, ae and induced_ae_norm_cossim (1,000 induced iterations
    # took 25-29 s on an 8-core host); ae's full fit, timed
    ae_iters: tuple = (1000, 200, 10000)
    # phase 19 (b): CUB-200's train rows, SSDH's code width and the
    # shallow fits' feature width (ViT-B/32's hidden size)
    unsup_fit: tuple = (5994, 64, 768)
    shallow_args: tuple = ()           # phase 19 (c): the itq run's overrides
    # phase 21: the backbone groups encoded (a); images a trunk encodes
    # and the CPU's share of them; the train batch; overrides for every
    # trunk config and by group
    trunk_groups: tuple = TRUNK_GROUPS
    trunk_images: int = 64
    trunk_side: int = 256              # the seeded images' side, cropped
    trunk_cpu_images: int = 16
    trunk_batch: int = 32
    trunk_args: tuple = ()
    trunk_over: tuple = ()


def check_sizes(sizes: Sizes) -> Sizes:
    """``sizes`` with ``graph_chunk`` at ``check_chunk``: the graph-vs-eager
    checks of phases 16 (b) to 19 (b) capture and replay chunks of that many
    steps (the capture and replay of the card's chunk of 8, in half the
    steps; phases 15 (a) and 20 (b) keep 8)."""
    return dataclasses.replace(sizes, graph_chunk=sizes.check_chunk)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, after one
    warm-up, from CUDA events. The device first spins for about 20 ms, so
    that all ``reps`` calls are queued before the first one runs: a call
    whose host work outlasts its kernels would otherwise be timed at the
    host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_s(fn, reps: int) -> float:
    """Mean wall seconds of ``fn`` ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def run_eval_s(exp) -> float:
    """Wall seconds of one more test-split encode of a finished run's
    experiment, ending in a device synchronize: the adsh regime's, whose
    run encodes its test split once, at its end (``eval_img_s`` reads the
    other runs' own second evaluation)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp.encode_split("test")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def time_encodes(exp) -> dict:
    """Wraps ``exp.encode_split`` so that the wall seconds of each split's
    last encode, from a device synchronize to one, are kept by split: after
    a 2-epoch run, those of its second evaluation, with no encode of their
    own."""
    secs = {}
    encode = exp.encode_split

    def timed(split, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(split, *args, **kw)
        torch.cuda.synchronize()
        secs[split] = time.perf_counter() - t0
        return out

    exp.encode_split = timed
    return secs


def eval_img_s(exp, secs: dict) -> tuple:
    """(images, img/s) of the test split's encode in the run's second
    evaluation, which ``time_encodes`` kept: warm, as the first evaluation
    ran the same eval batches, and free of graph captures (200 test images
    are fewer full batches than a chunk, so they run one a dispatch; the
    database's one chunk is captured in the second evaluation)."""
    n = len(exp.datasets["test"])
    return n, n / secs["test"]


def host_us(fn, reps: int) -> float:
    """Mean host microseconds to issue one call of ``fn`` (wrapper checks,
    tensor-map encoding, launches): each call timed alone on an idle device,
    so a full launch queue never stalls it."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / reps * 1e6


def _device_us(evt) -> float:
    """An operator's device time, the kernels of the operators it calls
    included."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_breakdown(name: str, fn, wall_s: float, rows: int = 12,
                     host_rows: int = 0, op_rows: int = 0,
                     warm: bool = True) -> list:
    """Trace one call of ``fn`` (after an untraced one where ``warm``):
    device time by kernel, and the device's busy share, the summed kernel
    time over ``wall_s`` (the untraced wall time of one call, as ``host_s``
    measured it). Ranges that user annotations put on the device timeline
    (``Optimizer.step#...``) span kernels already counted and are left out.
    The device table comes from the trace's raw events: building the
    profiler's event objects for every host operator of an eager train
    epoch took 20-30 s on an 8-core host. ``host_rows``: also the host operators with the
    most self CPU time (inflated by the profiler's own cost). ``op_rows``:
    also the PyTorch operators, by input shapes, with the most device time
    of the kernels they launched (inclusive: an operator that calls
    another counts that one's kernels too). Host activity is traced only
    for those two, or where there is no card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host = host_rows > 0 or op_rows > 0
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    if warm:
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities, record_shapes=op_rows > 0) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.duration_ns() <= 0):
            continue
        us, count = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    kernels = sorted(((key, us, count) for key, (us, count)
                      in by_name.items()), key=lambda k: k[1], reverse=True)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    print(f"{name}: device busy {busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms "
          f"wall ({100 * busy_ms / (wall_s * 1e3):.1f}%), "
          f"{sum(count for _, _, count in kernels)} kernels")
    for key, us, count in kernels[:rows]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {key[:100]}")
    if not host:
        return kernels
    averages = prof.key_averages()
    hosts = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                   key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in hosts[:host_rows]:
        print(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    if op_rows:
        ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                      if e.device_type == DeviceType.CPU
                      and e.key.startswith("aten::")
                      and _device_us(e) > 0),
                     key=lambda e: _device_us(e),
                     reverse=True)
        for e in ops[:op_rows]:
            print(f"  op {_device_us(e) / 1e3:9.3f} ms "
                  f"{e.count:4d}x  {e.key} {str(e.input_shapes)[:70]}")
    return kernels


# kernel names of csrc/fused_layer.cu, by part of the layer
LAYER_PARTS = (("GEMM", ("gemm_kernel",)),
               ("attention", ("attention_mma_kernel",)),
               ("LayerNorm/element-wise", ("layernorm_kernel",
                                           "row_stats_kernel")))


def layer_split(kernels, n_layers: int) -> None:
    """Kernel 1's device time in a traced run, split into its GEMMs, its
    attention and its LayerNorm passes, per layer."""
    parts = {part: sum(us for key, us, _ in kernels
                       if any(n in key for n in names))
             for part, names in LAYER_PARTS}
    total = sum(parts.values())
    print(f"  kernel 1 split (per layer, {n_layers} layers): "
          + ", ".join(f"{part} {us / n_layers / 1e3:.4f} ms "
                      f"({100 * us / total if total else 0.0:.1f}%)"
                      for part, us in parts.items()))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# kernel 1: the encoder layer
# ---------------------------------------------------------------------------

def random_layer(gen, D, F_, A, with_adapters, device):
    """Layer (and adapter) weights with std 1/sqrt(fan_in) matrices and small
    vectors, bf16 matrices on ``device``. The adapters' up-projections are
    random too, so both adapters carry signal."""
    from concepthash_tpu_torch.ops.fused_layer import (AdapterWeights,
                                                       LayerWeights)

    def mat(o, i):
        return torch.randn(o, i, generator=gen) / math.sqrt(i)

    def vec(n, s=0.02, base=0.0):
        return base + s * torch.randn(n, generator=gen)

    w = LayerWeights(vec(D, 0.1, 1.0), vec(D), mat(3 * D, D), vec(3 * D),
                     mat(D, D), vec(D), vec(D, 0.1, 1.0), vec(D), mat(F_, D),
                     vec(F_), mat(D, F_), vec(D))
    w = LayerWeights(*(t.to(device) for t in w)).cast(torch.bfloat16)
    if not with_adapters:
        return w, None, None
    ads = []
    for _ in range(2):
        a = AdapterWeights(vec(D, 0.1, 1.0), vec(D), mat(A, D), vec(A),
                           mat(D, A), vec(D), torch.ones(1))
        ads.append(AdapterWeights(*(t.to(device) for t in a)).cast(
            torch.bfloat16))
    return w, ads[0], ads[1]


def check_layer(sizes: Sizes, vcfg, device) -> float:
    from concepthash_tpu_torch.ops.fused_layer import (encoder_layer_cuda,
                                                       layer_reference)

    gen = torch.Generator().manual_seed(11)
    D, F_, H = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_heads
    L = vcfg.num_patches + 1 + sizes.head.get("ncontext", 4)
    worst = 0.0
    for batch, with_adapters in ((sizes.layer_batch, True),
                                 (sizes.layer_batch, False),
                                 *((b, True) for b in sizes.layer_batches_eval),
                                 (sizes.layer_batch_big, True)):
        w, a1, a2 = random_layer(gen, D, F_, sizes.bottleneck, with_adapters,
                                 device)
        x = torch.randn(batch, L, D, generator=gen).to(device, torch.bfloat16)
        kw = dict(num_heads=H, eps=vcfg.layer_norm_eps, act=vcfg.hidden_act,
                  adapter_attn=a1, adapter_mlp=a2)
        got = encoder_layer_cuda(x, w, **kw).float()
        torch.cuda.synchronize()
        want = layer_reference(x, w, **kw).float()
        err = (got - want).abs()
        excess = (err - (LAYER_ATOL + LAYER_RTOL * want.abs())).max().item()
        print(f"layer kernel vs plain, B={batch} L={L} D={D} "
              f"F={F_} H={H} adapters={'both' if with_adapters else 'none'}: "
              f"max |d| {err.max().item():.6g}, mean |d| "
              f"{err.mean().item():.3g}, max |ref| "
              f"{want.abs().max().item():.4g}")
        if not torch.isfinite(got).all() or excess > 0:
            fail(f"layer kernel outside |d| <= {LAYER_ATOL} + "
                 f"{LAYER_RTOL}|ref| (B={batch}, adapters={with_adapters})")
        worst = max(worst, err.max().item())
    return worst


def layer_library(x, w, a1, a2, num_heads, eps, act="quick_gelu"):
    """The same layer as a composition of PyTorch's own bf16 operators
    (F.layer_norm, F.linear, scaled_dot_product_attention): the timing
    yardstick, never called by the port. Weights all in bf16; ``act``
    quick_gelu or the exact gelu."""
    B, L, D = x.shape
    hd = D // num_heads

    def adapter(z, a):
        h = F.layer_norm(z, (D,), a.ln_scale, a.ln_bias, 1e-5)
        h = F.gelu(F.linear(h, a.w_down, a.b_down))
        return F.linear(h, a.w_up, a.b_up) * a.scale

    h = F.layer_norm(x, (D,), w.ln1_scale, w.ln1_bias, eps)
    q, k, v = F.linear(h, w.w_qkv, w.b_qkv).view(
        B, L, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        B, L, D)
    h = F.linear(o, w.w_out, w.b_out)
    if a1 is not None:
        h = h + adapter(h, a1)
    x = x + h
    h = F.linear(F.layer_norm(x, (D,), w.ln2_scale, w.ln2_bias, eps),
                 w.w_fc1, w.b_fc1)
    h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
    h = F.linear(h, w.w_fc2, w.b_fc2)
    if a2 is not None:
        h = h + adapter(h, a2)
    return x + h


def layer_flops_bytes(B, L, D, F_, A, n_adapters, w, adapters):
    flops = B * (2 * L * D * (3 * D + D + 2 * F_) + 4 * L * L * D
                 + n_adapters * 4 * L * D * A)
    params = sum(t.numel() * t.element_size() for t in w)
    params += sum(t.numel() * t.element_size()
                  for a in adapters if a is not None for t in a)
    return flops, 2 * B * L * D * 2 + params


# ---------------------------------------------------------------------------
# kernel 2: the subblock mins
# ---------------------------------------------------------------------------

def check_mins(sizes: Sizes, device) -> tuple:
    """Phase 3: the kernel against its plain version, exactly, in the
    serving layout ((Q, m_pad) mins and (Q, m_pad / 64) superblock mins, the
    pad columns at nbit + 1), over the packed and the plain layout; the
    plain layout also through ``subblock_min_dists`` (the reference's (m, Q)
    as a view). Returns the worst error of each layout."""
    from concepthash_tpu_torch.ops import topk_select as ts

    gen = torch.Generator(device=device).manual_seed(5)
    Q, N, S = sizes.mins_queries, sizes.mins_codes, 64
    worst = {"packed": 0.0, "plain": 0.0}
    for nbit, layout, dt in ((64, "packed", torch.bfloat16),
                             (64, "packed", torch.float32),
                             (64, "plain", torch.bfloat16),
                             (32, "packed", torch.bfloat16),
                             (16, "packed", torch.bfloat16),
                             (128, "plain", torch.bfloat16)):
        q = torch.randint(-1, 2, (Q, nbit), generator=gen, device=device)
        db = torch.randint(0, 2, (N, nbit), generator=gen, device=device,
                           dtype=torch.int8) * 2 - 1
        if layout == "packed":
            gal, n_codes = ts.pack_serving_gallery(db)
        else:
            gal, n_codes = db, N
        qi = ts.strict_signs(q)
        m = -(-n_codes // S)
        got, got_sb = ts.subblock_mins_cuda(qi, gal, n_codes, S, m, dt,
                                            superblocks=True)
        torch.cuda.synchronize()
        want, want_sb = ts._mins_reference_serving(
            qi, gal.reshape(n_codes, nbit), S, m, dt, superblocks=True)
        same = got.shape == want.shape and got_sb.shape == want_sb.shape
        err = max((got.float() - want.float()).abs().max().item(),
                  (got_sb.float() - want_sb.float()).abs().max().item()) \
            if same else float("inf")
        pads = bool((got[:, m:] == nbit + 1).all())
        if layout == "plain":
            view = ts.subblock_min_dists(q, gal, subblock=S, out_dtype=dt)
            torch.cuda.synchronize()
            err = max(err, (view.float() - want[:, :m].t().float()).abs()
                      .max().item() if view.shape == (m, Q) else float("inf"))
            del view
        print(f"mins kernel vs plain, Q={Q} N={n_codes} nbit={nbit} "
              f"{layout} S={S} {str(dt).split('.')[-1]}: mins "
              f"{tuple(got.shape)} and superblock mins "
              f"{tuple(got_sb.shape)}, max |d| {err}; pad columns at "
              f"nbit + 1: {pads}")
        if err != 0 or not pads:
            fail(f"mins kernel differs from its plain version "
                 f"(nbit={nbit}, {layout}, {dt})")
        worst[layout] = max(worst[layout], err)
        del gal, db, got, want, got_sb, want_sb
    return worst["packed"], worst["plain"]


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------

class plain_layers:
    """Inside this block the model's encoder layers run the kernel's plain
    version (the reference encode the kernel's codes are checked against)."""

    def __enter__(self):
        from concepthash_tpu_torch.models import clip
        from concepthash_tpu_torch.ops.fused_layer import layer_reference

        self.clip, self.saved = clip, clip.encoder_layer
        clip.encoder_layer = lambda x, w, **kw: layer_reference(x, w, **kw)

    def __exit__(self, *exc):
        self.clip.encoder_layer = self.saved


def build_model(sizes: Sizes, device, dtype=torch.bfloat16):
    from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                                   ClipVisionConfig)
    from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                          ConceptHashConfig)

    gen = torch.Generator().manual_seed(0)
    vcfg = ClipVisionConfig(**sizes.vision)
    model = ConceptHash(vcfg, ConceptHashConfig(**sizes.head),
                        AdapterConfig(bottleneck_dim=sizes.bottleneck),
                        dtype=dtype, device=device, generator=gen)
    # the adapters' up-projections start at zero; seeded values make both
    # adapters change the codes, so the check covers them
    with torch.no_grad():
        for layer in model.backbone.layers:
            for ad in (layer.adapter_attn, layer.adapter_mlp):
                ad.up.weight.copy_(0.02 * torch.randn(
                    ad.up.weight.shape, generator=gen))
    return model.eval(), vcfg


def check_f32_encode(sizes: Sizes, images, codes_bf16, device) -> None:
    """The same weights at compute dtype float32 encode ``images`` on the
    card (the discrete path: the layer kernel takes bf16 only) and their
    first ``sizes.f32_cpu_images`` on the CPU (an image's codes depend on
    it alone); the codes are finite, of the bf16 codes' shape, and agree
    in sign on >= 99% of bits with the CPU's and with the bf16 codes."""
    model, _ = build_model(sizes, device, torch.float32)
    with torch.inference_mode():
        sec = host_s(lambda: model(images), 1)
        codes = model(images)["codes"]
    del model
    cpu_model, _ = build_model(sizes, torch.device("cpu"), torch.float32)
    n_cpu = min(sizes.f32_cpu_images, images.shape[0])
    t0 = time.perf_counter()
    with torch.inference_mode():
        codes_cpu = cpu_model(images[:n_cpu].cpu())["codes"]
    cpu_s = time.perf_counter() - t0
    del cpu_model
    first = codes[:n_cpu].cpu()
    vs_cpu = ((first > 0) == (codes_cpu > 0)).float().mean().item()
    vs_bf16 = ((codes > 0) == (codes_bf16 > 0)).float().mean().item()
    B = images.shape[0]
    print(f"f32 encode ({B} images, compute dtype float32, the discrete "
          f"path): {B / sec:.1f} img/s on the card ({sec * 1e3:.2f} ms), "
          f"the first {n_cpu} in {cpu_s:.1f} s on the CPU; sign agreement "
          f"with the CPU's codes {vs_cpu:.6f} (max |d| "
          f"{(first - codes_cpu).abs().max().item():.4g}), with the bf16 "
          f"codes {vs_bf16:.6f}")
    if (codes.shape != codes_bf16.shape or not torch.isfinite(codes).all()
            or min(vs_cpu, vs_bf16) < MIN_SIGN_AGREEMENT):
        fail(f"f32 encode: codes {tuple(codes.shape)} not finite, or sign "
             f"agreement {vs_cpu:.4f} (CPU) / {vs_bf16:.4f} (bf16) < "
             f"{MIN_SIGN_AGREEMENT}")


def _wrappers():
    """The launch-counting kernel wrappers: encoder layer, subblock mins,
    LN -> matmul, attention, bit-plane mins."""
    from concepthash_tpu_torch.ops.attention import attention_cuda
    from concepthash_tpu_torch.ops.fused_layer import encoder_layer_cuda
    from concepthash_tpu_torch.ops.fused_ln import ln_matmul_cuda
    from concepthash_tpu_torch.ops.topk_select import (
        subblock_mins_bitplane_cuda, subblock_mins_cuda)

    return (encoder_layer_cuda, subblock_mins_cuda, ln_matmul_cuda,
            attention_cuda, subblock_mins_bitplane_cuda)


def count_reset():
    for w in _wrappers():
        w.launches = 0
    _wrappers()[1].plain_launches = 0


def counts() -> tuple:
    """Launches per kernel entry: encoder_layer, subblock_mins over the
    packed layout (kernel 2) and over the plain one (kernel 3), ln_matmul,
    attention, bitplane_mins."""
    layer, mins, ln, att, bp = _wrappers()
    return (layer.launches, mins.launches - mins.plain_launches,
            mins.plain_launches, ln.launches, att.launches, bp.launches)


# ---------------------------------------------------------------------------
# kernels 5 and 6: attention and LayerNorm -> matmul
# ---------------------------------------------------------------------------

def ln_inputs(gen, N, D, F_, device):
    """x with a non-zero mean and spread; gamma near 1; W with std
    1/sqrt(D); bf16 x and W, f32 vectors."""
    x = (2 * torch.randn(N, D, generator=gen) + 0.5).to(device, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(D, generator=gen)).to(device)
    beta = (0.1 * torch.randn(D, generator=gen)).to(device)
    w = (torch.randn(F_, D, generator=gen) / math.sqrt(D)).to(
        device, torch.bfloat16)
    bias = (0.1 * torch.randn(F_, generator=gen)).to(device)
    return x, gamma, beta, w, bias


def qkv_views(gen, B, L, D, H, device):
    """q, k, v as (B, L, H, hd) views of one (B, L, 3D) bf16 tensor, the
    layout the model hands the attention kernel."""
    qkv = torch.randn(B, L, 3 * D, generator=gen).to(device, torch.bfloat16)
    return [t.reshape(B, L, H, D // H) for t in qkv.split(D, dim=-1)]


def check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    excess = (err - (atol + rtol * want.float().abs())).max().item()
    print(f"{name}: max |d| {err.max().item():.6g}, mean |d| "
          f"{err.mean().item():.3g}, max |ref| "
          f"{want.float().abs().max().item():.4g}")
    if got.shape != want.shape or not torch.isfinite(got).all() or excess > 0:
        fail(f"{name} outside |d| <= {atol} + {rtol}|ref|")
    return err.max().item()


def check_ln_matmul(sizes: Sizes, vcfg, device) -> float:
    from concepthash_tpu_torch.ops.fused_ln import (ln_matmul_cuda,
                                                    ln_matmul_reference)

    gen = torch.Generator().manual_seed(13)
    D = vcfg.hidden_size
    worst = 0.0
    for N in (*sizes.ln_rows, sizes.ln_rows_big):
        for F_ in (3 * D, vcfg.intermediate_size):
            args = ln_inputs(gen, N, D, F_, device)
            got = ln_matmul_cuda(*args, eps=vcfg.layer_norm_eps)
            torch.cuda.synchronize()
            want = ln_matmul_reference(*args, eps=vcfg.layer_norm_eps)
            worst = max(worst, check_close(
                f"ln_matmul kernel vs plain, N={N} D={D} F={F_}", got, want,
                LN_ATOL, LN_RTOL))
    return worst


def check_attention(sizes: Sizes, vcfg, device) -> float:
    from concepthash_tpu_torch.ops.attention import (attention_cuda,
                                                     attention_reference)

    gen = torch.Generator().manual_seed(17)
    D, H = vcfg.hidden_size, vcfg.num_heads
    worst = 0.0
    for L in sizes.attn_lengths:
        q, k, v = qkv_views(gen, sizes.attn_batch, L, D, H, device)
        got = attention_cuda(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        worst = max(worst, check_close(
            f"attention kernel vs plain, B={sizes.attn_batch} L={L} H={H} "
            f"hd={D // H} (q|k|v views)", got, want, ATTN_ATOL, ATTN_RTOL))
    return worst


class plain_kernels:
    """Inside this block the LN -> matmul and attention wrappers run their
    plain versions (the reference train step the kernels' is held
    against)."""

    def __enter__(self):
        from concepthash_tpu_torch.ops import attention, fused_ln

        self.saved = (fused_ln.ln_matmul_cuda, attention.attention_cuda)
        self.mods = (fused_ln, attention)
        fused_ln.ln_matmul_cuda = fused_ln.ln_matmul_reference
        attention.attention_cuda = attention.attention_reference

    def __exit__(self, *exc):
        self.mods[0].ln_matmul_cuda, self.mods[1].attention_cuda = self.saved


def grads_vs_plain(model, loss_fn, batch: dict) -> tuple:
    """The train-mode loss and the gradient of every trained tensor with
    the kernels and with their plain versions: (loss with the kernels,
    loss plain, {trained tensor: cosine of the two gradients}). Raw
    gradients, where an adam step would turn components that cancel to
    rounding size into sign flips of a full step."""
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}

    def grads():
        total, _ = loss_fn(model(batch["image"], train=True), batch)
        return float(total), torch.autograd.grad(total, list(
            trained.values()))

    loss_k, g_k = grads()
    with plain_kernels():
        loss_p, g_p = grads()
    return loss_k, loss_p, {
        n: F.cosine_similarity(a.double().flatten(), b.double().flatten(),
                               dim=0).item()
        for n, a, b in zip(trained, g_k, g_p)}


def step_vs_plain(tr, batch: dict) -> tuple:
    """One train step of ``tr`` (a ``methods.Training``) with the kernels
    and one from the same state with their plain versions (the dropout
    generator reseeded for each); the state is restored after each.
    Returns (loss with the kernels, loss plain, {trained tensor: cosine of
    the two updates})."""
    loss_k, loss_p, upd_k, upd_p = steps_kernels_plain(tr, batch)
    return loss_k, loss_p, {
        n: F.cosine_similarity(upd_k[n], upd_p[n], dim=0).item()
        for n in upd_k}


def steps_kernels_plain(tr, batch: dict) -> tuple:
    """``step_vs_plain``'s two steps: (loss with the kernels, loss plain,
    {trained tensor: update with the kernels}, {...: update plain}), the
    updates float64 and flat."""
    model = tr.model
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    snap = (copy.deepcopy(model.state_dict()),
            copy.deepcopy(tr.optimizer.state_dict()),
            copy.deepcopy(tr.scheduler.state_dict()))
    start = {n: p.detach().clone() for n, p in trained.items()}

    def one_step():
        tr.generator.manual_seed(1)
        loss = float(tr.step(batch)["loss"])
        upd = {n: (p.detach() - start[n]).double().flatten()
               for n, p in trained.items()}
        model.load_state_dict(snap[0])
        tr.optimizer.load_state_dict(snap[1])
        tr.scheduler.load_state_dict(snap[2])
        return loss, upd

    loss_k, upd_k = one_step()
    with plain_kernels():
        loss_p, upd_p = one_step()
    return loss_k, loss_p, upd_k, upd_p


# ---------------------------------------------------------------------------
# the train slice
# ---------------------------------------------------------------------------

def train_config(sizes: Sizes) -> dict:
    """main.py's config dicts for the canonical ConceptHash
    (configs/model/concepthash.yaml with adam and csw), in bf16."""
    head = sizes.head
    return {
        "model": {"name": "concepthash", "nbit": head["nbit"],
                  "nclass": head["nclass"],
                  "ncontext": head.get("ncontext", 4), "has_adapter": True,
                  "adapter_bottleneck_dim": sizes.bottleneck,
                  "upt_config": {"multi": True, "num_heads": 8,
                                 "dropout": 0.1, "ensemble_method": "concat",
                                 "single_hash_fc": True, "hash_pe": True},
                  "add_bn": True, "use_before_projection": True,
                  "concept_reg": True,
                  "text_projection_dims": list(head["text_projection_dims"])},
        "backbone": ({"name": "cut", **sizes.vision} if sizes.vision
                     else {"name": "openai/clip-vit-base-patch32"}),
        "criterion": {"name": "lgh", "margin": 0.2, "scale": 8,
                      "loss_scales": {"logits": 0, "hash_logits": 0,
                                      "bin_logits": 1, "cont_logits": 1,
                                      "attn_div_loss": 0,
                                      "concept_logits": 1},
                      "avg_before_softmax": False, "lmbd": 0.5,
                      "div_method": 1, "ncontext": head.get("ncontext", 4)},
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 10},
        "epochs": 100, "backbone_lr_scale": 0,
        "batch_size": sizes.train_batch, "compute_dtype": "bfloat16",
        "seed": 0,
    }


def run_train(sizes: Sizes, device) -> dict:
    """Phases 7 and 8. Returns the numbers of both kernels' JSON entries."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_training
    from concepthash_tpu_torch.ops import attention as at
    from concepthash_tpu_torch.ops import fused_ln as fln

    cfg = train_config(sizes)
    nclass = cfg["model"]["nclass"]
    centers = torch.randn(nclass, sizes.head.get("center_dim", 512),
                          generator=torch.Generator().manual_seed(0))
    tr = build_training(cfg, centers, sizes.steps_per_epoch, device=device,
                        vision=TRAIN_VISION)
    model = tr.model
    vcfg = model.vision_cfg
    n_lay = vcfg.num_layers
    dgen = torch.Generator(device=device).manual_seed(1)

    def batch_of(n):
        raw = torch.randint(0, 256, (n, sizes.image_side, sizes.image_side, 3),
                            generator=dgen, device=device, dtype=torch.uint8)
        y = torch.randint(0, nclass, (n,), generator=dgen, device=device)
        return {"image": normalize(center_crop(raw, vcfg.image_size), 3),
                "label": F.one_hot(y, nclass).float()}

    batch = batch_of(sizes.train_batch)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    torch.cuda.synchronize()

    # ---- the main path, with the launch counts from zero ----
    count_reset()
    losses, per_step = [], []
    for _ in range(sizes.train_steps):
        before = counts()
        tr.generator.manual_seed(1)         # the same dropout masks each step
        losses.append(float(tr.step(batch)["loss"]))
        per_step.append(tuple(a - b for a, b in zip(counts(), before)))
    torch.cuda.synchronize()
    launches = counts()
    print(f"train steps (B={sizes.train_batch}): loss "
          + ", ".join(f"{x:.5f}" for x in losses))
    print(f"train launches per step (encoder_layer, subblock_mins packed, "
          f"plain, ln_matmul, attention, bitplane_mins): {per_step}; "
          f"expected (0, 0, 0, {2 * n_lay}, {n_lay}, 0)")
    if any(s != (0, 0, 0, 2 * n_lay, n_lay, 0) for s in per_step):
        fail("a kernel of the train path was not launched as expected")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail("train loss not finite, or not lower at the last step")
    moved = [n for n, p in model.named_parameters()
             if n in frozen and not torch.equal(p.detach(), frozen[n])]
    print(f"frozen parameters: {len(frozen)}, changed: {len(moved)}; "
          f"trained: {len(trained)}")
    if moved or not frozen:
        fail(f"frozen parameters changed: {moved[:5]}")

    # ---- one step with the kernels against one with the plain versions ----
    loss_k, loss_p, cos = step_vs_plain(tr, batch)
    held = {n: c for n, c in cos.items() if n not in NULL_GRADIENT}
    worst = min(held, key=held.get)
    print(f"train step, kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f}; "
          f"update cosine min {held[worst]:.6f} ({worst}), mean "
          f"{sum(held.values()) / len(held):.6f}; null-gradient tensors "
          + ", ".join(f"{n} {cos[n]:.3f}" for n in NULL_GRADIENT))
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p):
        fail(f"train loss with kernels {loss_k} vs plain {loss_p}")
    if held[worst] < MIN_UPDATE_COSINE:
        fail(f"update of {worst} at cosine {held[worst]} < "
             f"{MIN_UPDATE_COSINE}")

    # ---- train timings ----
    xla = build_training(cfg, centers, sizes.steps_per_epoch, device=device,
                         vision=XLA_VISION)
    xla.model.load_state_dict(model.state_dict())
    big = batch_of(sizes.train_batch_big)
    step_s = {}
    for name, t in (("kernels", tr), ("xla", xla)):
        for b in (batch, big):
            n = b["label"].shape[0]
            step_s[name, n] = host_s(lambda: t.step(b), 3)
            print(f"train ({name}, B={n}): {n / step_s[name, n]:.1f} img/s "
                  f"({step_s[name, n] * 1e3:.2f} ms per step)")
    n_big = sizes.train_batch_big
    device_breakdown(f"train step (B={n_big}, kernels)", lambda: tr.step(big),
                     step_s["kernels", n_big], rows=8)
    del xla, big

    D, H, Fm = vcfg.hidden_size, vcfg.num_heads, vcfg.intermediate_size
    L = vcfg.num_patches + 1 + cfg["model"]["ncontext"]
    N = sizes.train_batch * L
    gen = torch.Generator().manual_seed(19)
    eps = vcfg.layer_norm_eps
    ln, ln_big = ({"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "host_us": 0.0, "flops": 0, "bytes": 0} for _ in range(2))
    for n, r in ((N, ln), (sizes.ln_rows_big, ln_big)):
        for F_ in (3 * D, Fm):
            x, g, b, w, bias = ln_inputs(gen, n, D, F_, device)
            g16, b16, bias16 = (t.to(torch.bfloat16) for t in (g, b, bias))
            r["ms"] += cuda_ms(
                lambda: fln.ln_matmul_cuda(x, g, b, w, bias, eps), sizes.reps)
            r["plain_ms"] += cuda_ms(
                lambda: fln.ln_matmul_reference(x, g, b, w, bias, eps), 3)
            r["library_ms"] += cuda_ms(lambda: F.linear(
                F.layer_norm(x, (D,), g16, b16, eps), w, bias16), sizes.reps)
            r["host_us"] += host_us(
                lambda: fln.ln_matmul_cuda(x, g, b, w, bias, eps), sizes.reps)
            r["flops"] += 2 * n * D * F_
            r["bytes"] += (n * D * 2 + 2 * D * 4 + F_ * D * 2 + F_ * 4
                           + n * F_ * 2)
    q, k, v = qkv_views(gen, sizes.train_batch, L, D, H, device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    att = dict(ms=cuda_ms(lambda: at.attention_cuda(q, k, v), sizes.reps),
               plain_ms=cuda_ms(lambda: at.attention_reference(q, k, v), 3),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt), sizes.reps),
               flops=4 * sizes.train_batch * H * L * L * (D // H),
               bytes=4 * sizes.train_batch * L * D * 2)
    # the large-batch step's attention, beside SDPA (printed only)
    q, k, v = qkv_views(gen, sizes.train_batch_big, L, D, H, device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    big_ms = cuda_ms(lambda: at.attention_cuda(q, k, v), sizes.reps)
    big_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                      sizes.reps)
    print(f"attention (B={sizes.train_batch_big}, L={L}, H={H}, "
          f"hd={D // H}): kernel {big_ms:.4f} ms, library (SDPA) "
          f"{big_lib:.4f} ms")
    del q, k, v, qt, kt, vt
    for name, r, shape in (
            ("ln_matmul", ln, f"N={N}, D={D}, F={3 * D} + F={Fm}, one "
                              "q|k|v and one fc1 call"),
            ("ln_matmul", ln_big, f"N={sizes.ln_rows_big}, D={D}, "
                                  f"F={3 * D} + F={Fm}, the B="
                                  f"{sizes.train_batch_big} step's pair"),
            ("attention", att, f"B={sizes.train_batch}, L={L}, H={H}, "
                               f"hd={D // H}")):
        t_ops, t_bytes = r["flops"] / BF16_PEAK, r["bytes"] / HBM_RATE
        r["bound_ms"] = max(t_ops, t_bytes) * 1e3
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        host = (f"; host {r['host_us']:.1f} us per pair of calls"
                if "host_us" in r else "")
        print(f"{name} ({shape}): kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB), "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms; {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s{host}")
    device_breakdown(f"train step (B={sizes.train_batch}, kernels)",
                     lambda: tr.step(batch),
                     step_s["kernels", sizes.train_batch], host_rows=10)
    ln["launches"], att["launches"] = launches[3], launches[4]
    return {"ln_matmul": ln, "attention": att}


# ---------------------------------------------------------------------------
# kernel 4: the bit-plane mins, and the bit-plane serving slice
# ---------------------------------------------------------------------------

def check_bitplane_mins(sizes: Sizes, device) -> float:
    """Phase 9: the kernel against its plain version, exactly, in the
    serving layout ((Q, m_pad) mins and (Q, m_pad / 64) superblock mins,
    the pad columns at nbit + 1), with n_rows masking the byte-pad rows
    while the pack-pad slots stay in."""
    from concepthash_tpu_torch.ops import topk_select as ts

    gen = torch.Generator(device=device).manual_seed(23)
    Q, N, S = sizes.mins_queries, sizes.mins_codes, sizes.bitplane_subblock
    worst = 0.0
    for nbit, dt in ((64, torch.bfloat16), (64, torch.float32),
                     (32, torch.bfloat16), (32, torch.float32)):
        P = 128 // nbit
        q = torch.randint(-1, 2, (Q, nbit), generator=gen, device=device)
        db = torch.randint(0, 2, (N, nbit), generator=gen, device=device,
                           dtype=torch.int8) * 2 - 1
        bp, n_pad = ts.pack_bitplane_serving(db)
        n_rows = -(-N // P)
        m = -(-n_pad // S)
        qi = ts.strict_signs(q)
        got, got_sb = ts.subblock_mins_bitplane_cuda(qi, bp, n_rows, S, m, dt,
                                                     superblocks=True)
        torch.cuda.synchronize()
        want, want_sb = ts._bitplane_mins_reference(qi, bp, n_rows, S, m, dt,
                                                    superblocks=True)
        same = got.shape == want.shape and got_sb.shape == want_sb.shape
        err = max((got.float() - want.float()).abs().max().item(),
                  (got_sb.float() - want_sb.float()).abs().max().item()) \
            if same else float("inf")
        pads = bool((got[:, m:] == nbit + 1).all())
        print(f"bitplane mins kernel vs plain, Q={Q} N={N} (stored {n_pad}, "
              f"{n_rows} of {bp.shape[0] * 8} packed rows valid) nbit={nbit} "
              f"S={S} {str(dt).split('.')[-1]}: mins {tuple(got.shape)} and "
              f"superblock mins {tuple(got_sb.shape)}, max |d| {err}; pad "
              f"columns at nbit + 1: {pads}")
        if err != 0 or not pads:
            fail(f"bit-plane mins kernel differs from its plain version "
                 f"(nbit={nbit}, {dt})")
        worst = max(worst, err)
        del bp, db, got, want
    return worst


def plant_bitplane(bp, codes, nbit, gen):
    """Write ``codes`` into a bit-plane gallery at random codes, one per
    byte row, by unpacking, editing and repacking those byte rows. Returns
    the planted code indices."""
    from concepthash_tpu_torch.ops import topk_select as ts

    B, P = codes.shape[0], 128 // nbit
    g = torch.randperm(bp.shape[0], generator=gen, device=bp.device)[:B]
    slot = torch.randint(0, 8 * P, (B,), generator=gen, device=bp.device)
    rows = ts.unpack_bitplane(bp[g]).view(B, 8, P, nbit)
    rows[torch.arange(B, device=bp.device), slot // P, slot % P] = \
        ts.strict_signs(codes)
    bp[g] = ts.pack_bitplane_serving(rows.view(B * 8, 128), nbit=nbit)[0]
    return g * 8 * P + slot


def bitplane_code_distances(bp, codes, idx, nbit):
    """Hamming distances of the codes at ``idx`` (Q, k) of a bit-plane
    gallery to their queries, read straight from the bytes."""
    P = 128 // nbit
    g, plane, slot = idx // (8 * P), (idx // P) % 8, idx % P
    lanes = slot[..., None] * nbit + torch.arange(nbit, device=idx.device)
    bits = (bp[g[..., None], lanes] >> plane[..., None].to(torch.uint8)) & 1
    qbits = (codes > 0).to(torch.uint8)[:, None, :]
    return (bits != qbits).sum(dim=-1).float()


def plain_walk(bp, codes, k, nbit, block_codes, subblock, n_codes):
    """The reference answer for a bit-plane gallery: unpack it a block at a
    time, full distance matrix per block, exact top-k per block (values),
    merged; and the subblock mins of those distances, (Q, m), with codes at
    or past ``n_codes`` and past the stored ones at nbit + 1, as the mins
    kernel counts them. ``block_codes`` is a multiple of ``subblock``."""
    from concepthash_tpu_torch.ops import topk_select as ts
    from concepthash_tpu_torch.ops.retrieval import sign_distances

    Q = codes.shape[0]
    gb = block_codes * nbit // 1024                  # byte rows per block
    best = torch.full((Q, k), float("inf"), device=codes.device)
    mins = []
    for g0 in range(0, bp.shape[0], gb):
        rows = ts.unpack_bitplane(bp[g0:g0 + gb]).view(-1, nbit)
        d = sign_distances(codes, rows)
        vals = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False).values
        best = torch.topk(torch.cat([best, vals], dim=1), k, dim=1,
                          largest=False).values
        c0 = g0 * 1024 // nbit
        col = torch.arange(d.shape[1], device=d.device) + c0
        d = torch.where(col < n_codes, d, float(nbit + 1))
        pad = (-d.shape[1]) % subblock
        d = F.pad(d, (0, pad), value=float(nbit + 1))
        mins.append(d.view(Q, -1, subblock).amin(dim=2))
    return best, torch.cat(mins, dim=1)


def distance_recall(got, want, nbit) -> float:
    """Distance-level recall: the share of the exact top-k distance
    multiset that ``got`` recovers, averaged over queries."""
    def hist(d):
        return F.one_hot(d.clamp(max=nbit + 1).long(), nbit + 2).sum(dim=1)
    k = want.shape[1]
    return (torch.minimum(hist(got), hist(want)).sum(dim=1).float()
            / k).mean().item()


def run_bitplane(sizes: Sizes, device, codes, nbit: int) -> dict:
    """Phase 10: serve the encoded codes from a 10^8-code bit-plane gallery,
    counted, checked against a plain walk (kernel 4's mins at the path's own
    arguments too), and timed with kernel 4 at the serving point and at
    2^20. Returns kernel 4's JSON numbers, those of the serving point."""
    from concepthash_tpu_torch.ops import topk_select as ts

    gen = torch.Generator(device=device).manual_seed(29)
    B, k, S = codes.shape[0], sizes.k, sizes.bitplane_subblock
    N = sizes.bitplane_codes
    G = N * nbit // 1024
    bp = torch.randint(0, 256, (G, 128), generator=gen, device=device,
                       dtype=torch.uint8)               # born bit-plane
    planted = plant_bitplane(bp, codes, nbit, gen)
    torch.cuda.synchronize()

    # ---- the main path, once, with the launch counts from zero ----
    count_reset()
    with torch.inference_mode():
        d, idx, valid = ts.exact_topk_bitplane(codes, bp, k, subblock=S,
                                               n_valid=N)
    torch.cuda.synchronize()
    n_bp = counts()[5]
    m = -(-N // S)
    print(f"bit-plane serving: {B} queries over {N} codes ({G} byte rows, "
          f"{G * 128 / 1e6:.0f} MB), S={S}, m={m}; launches: bitplane_mins "
          f"{n_bp}; certificate {valid}")
    if n_bp < 1:
        fail("the bit-plane mins kernel was not launched on the main path")
    hit = ((idx == planted[:, None]) & (d == 0)).any(dim=1)
    print(f"bit-plane serving: planted rows found at distance 0: "
          f"{int(hit.sum())}/{B}")
    # kernel 4 at the main path's own arguments (the rows exact_topk_bitplane
    # keeps for an int n_valid, its bf16 mins) against the walk's mins
    P = 128 // nbit
    n_rows = min(G * 8, -(-N // P))
    with torch.inference_mode():
        walk, walk_mins = plain_walk(bp, codes, k, nbit, sizes.walk_codes, S,
                                     n_rows * P)
        scored = bitplane_code_distances(bp, codes, idx, nbit)
        got_mins = ts.subblock_min_dists_bitplane(
            codes, bp, subblock=S, out_dtype=torch.bfloat16, n_rows=n_rows)
    torch.cuda.synchronize()
    same_shape = tuple(got_mins.shape) == (m, B) == tuple(walk_mins.t().shape)
    mins_err = ((got_mins.float().t() - walk_mins).abs().max().item()
                if same_shape else float("inf"))
    del got_mins, walk_mins
    same_d, consistent = torch.equal(d, walk), torch.equal(scored, d)
    print(f"bit-plane serving: kernel 4's ({m}, {B}) mins at the main path's "
          f"arguments (n_rows={n_rows}) vs the plain walk's subblock mins: "
          f"max |d| {mins_err}")
    print(f"bit-plane serving: distances equal the plain walk's: {same_d}; "
          f"indices score their distances: {consistent}")
    if mins_err != 0:
        fail("bit-plane mins kernel differs from the plain walk's mins at "
             "the serving point")
    if not (valid and hit.all() and same_d and consistent):
        fail("bit-plane serving: certificate, planted rows or distances "
             "wrong")

    with torch.inference_mode():
        srv_s = host_s(lambda: ts.exact_topk_bitplane(codes, bp, k,
                                                      subblock=S, n_valid=N),
                       3)
    print(f"bit-plane serving: {B / srv_s:.1f} queries/s "
          f"(exact_topk_bitplane, k={k}, {B} queries over {N} codes, "
          f"{srv_s * 1e3:.2f} ms)")
    qi = ts.strict_signs(codes)

    def bound(n_codes, m_rows):
        nbytes = n_codes * nbit // 8 + B * nbit + m_rows * B * 2
        ops = 2 * B * n_codes * nbit
        t_b, t_o = nbytes / HBM_RATE, ops / INT8_PEAK
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
                nbytes, ops)

    # plain version and yardstick in blocks of walk_codes codes: neither
    # holds the serving point's (N, Q) products in device memory at once
    gb = sizes.walk_codes * nbit // 1024

    def in_blocks(fn):
        def go():
            for g0 in range(0, G, gb):
                blk = bp[g0:g0 + gb]
                fn(blk, blk.shape[0] * 8 * P)
        return go

    def library(blk, n):                     # unpack + int8 GEMM + amax
        sim = torch._int_mm(ts.unpack_bitplane(blk).view(n, nbit), qi.t())
        return (0.5 * (nbit - sim.view(n // S, S, B).amax(dim=1))).to(
            torch.bfloat16)

    with torch.inference_mode():
        big_ms = cuda_ms(lambda: ts.subblock_mins_bitplane_cuda(
            qi, bp, n_rows, S, m, torch.bfloat16, superblocks=True),
            max(3, sizes.reps // 2))
        big_plain_ms = cuda_ms(in_blocks(
            lambda blk, n: ts._bitplane_mins_reference(
                qi, blk, n // P, S, -(-n // S), torch.bfloat16)), 2)
        big_lib_ms = cuda_ms(in_blocks(library), 2)
    big = bound(N, m)
    print(f"bitplane_mins at the serving point (Q={B}, N={N}, nbit={nbit}, "
          f"S={S}, bf16): kernel {big_ms:.4f} ms, bound {big[0]:.4f} ms "
          f"({big[1]}: {big[2] / 1e6:.1f} MB, {big[3] / 1e9:.1f} G int8 "
          f"ops), plain {big_plain_ms:.4f} ms and library (unpack_bitplane + "
          f"torch._int_mm + amax) {big_lib_ms:.4f} ms, both in "
          f"{-(-G // gb)} blocks of {sizes.walk_codes} codes")
    with torch.inference_mode():
        device_breakdown("bit-plane serving", lambda: ts.exact_topk_bitplane(
            codes, bp, k, subblock=S, n_valid=N), srv_s, op_rows=8)
    del bp

    # ---- kernel 4 at Q=256, N=2^20, where it compares with kernel 2 ----
    n20, s20 = sizes.gallery, 64
    bp20 = torch.randint(0, 256, (n20 * nbit // 1024, 128), generator=gen,
                         device=device, dtype=torch.uint8)
    m20 = -(-n20 // s20)
    with torch.inference_mode():
        ms = cuda_ms(lambda: ts.subblock_mins_bitplane_cuda(
            qi, bp20, bp20.shape[0] * 8, s20, m20, torch.bfloat16,
            superblocks=True), sizes.reps)
        plain_ms = cuda_ms(lambda: ts._bitplane_mins_reference(
            qi, bp20, bp20.shape[0] * 8, s20, m20, torch.bfloat16), 3)
        lib_ms = cuda_ms(lambda: (0.5 * (nbit - torch._int_mm(
            ts.unpack_bitplane(bp20).view(n20, nbit), qi.t()).view(
                m20, s20, B).amax(dim=1))).to(torch.bfloat16), sizes.reps)
    b20 = bound(n20, m20)
    print(f"bitplane_mins (Q={B}, N={n20}, nbit={nbit}, S={s20}, bf16): "
          f"kernel {ms:.4f} ms, bound {b20[0]:.4f} ms ({b20[1]}: "
          f"{b20[2] / 1e6:.1f} MB, {b20[3] / 1e9:.1f} G int8 ops), plain "
          f"{plain_ms:.4f} ms, library (unpack_bitplane + torch._int_mm + "
          f"amax) {lib_ms:.4f} ms")
    return dict(launches=n_bp, max_abs_err=mins_err, ms=big_ms,
                plain_ms=big_plain_ms, bound_ms=big[0], bound_by=big[1],
                library_ms=big_lib_ms)


def run_approx(sizes: Sizes, codes, gallery, packed, bits,
               n_pad: int) -> None:
    """Phase 11: exact=False over the 2^20 gallery of phase 4 beside the
    exact path, the other option for it: queries/s, distance-level recall
    against the exact answer, and whether the indices score their
    distances."""
    from concepthash_tpu_torch.ops.retrieval import (retrieve_topk,
                                                     retrieve_topk_streaming,
                                                     sign_distances)

    B, k, nbit = codes.shape[0], sizes.k, codes.shape[1]
    N = gallery.shape[0]
    flat = packed.reshape(n_pad, nbit)
    exact = "retrieve_topk exact=True (subblock mins + rescore)"
    options = {
        "retrieve_topk exact=False (bf16 sign products + torch.topk)":
            lambda: retrieve_topk(codes, flat, k=k, exact=False, n_valid=N),
        "retrieve_topk_streaming exact=False (the same, per block)":
            lambda: retrieve_topk_streaming(codes, packed, k=k,
                                            db_block=n_pad, exact=False,
                                            n_valid=N),
        exact: lambda: retrieve_topk(codes, flat, k=k, exact=True,
                                     n_valid=N),
        "retrieve_topk_streaming exact=True (minspass, gallery bit-pack "
        "given)": lambda: retrieve_topk_streaming(
            codes, packed, k=k, db_block=n_pad, exact=True, n_valid=N,
            db_bits=bits),
    }
    with torch.inference_mode():
        exact_d, _ = options[exact]()
        dist = sign_distances(codes, gallery)
        for name, fn in options.items():
            d, idx = fn()
            recall = distance_recall(d, exact_d, nbit)
            consistent = torch.equal(dist.gather(1, idx), d)
            s = host_s(fn, 5)
            print(f"{name}: {B / s:.1f} queries/s ({s * 1e3:.2f} ms), "
                  f"distance-level recall@{k} {recall:.6f}, indices score "
                  f"their distances: {consistent}")
            if recall < MIN_APPROX_RECALL or not consistent:
                fail(f"{name}: recall {recall} < {MIN_APPROX_RECALL} or "
                     f"indices inconsistent")


def run_scoring(sizes: Sizes, codes, nclass: int, device) -> None:
    """Phase 12: calculate_mAP and calculate_pr_curve on the card against
    the same calls on the CPU."""
    from concepthash_tpu_torch.ops.retrieval import (calculate_mAP,
                                                     calculate_pr_curve)

    gen = torch.Generator().manual_seed(31)
    db = torch.randn(sizes.scoring_db, codes.shape[1], generator=gen)
    db_labels = torch.randint(0, nclass, (sizes.scoring_db,), generator=gen)
    q_labels = torch.randint(0, nclass, (codes.shape[0],), generator=gen)
    q = codes.float().cpu()
    calls = {
        "mAP R=-1": lambda dev: calculate_mAP(db, db_labels, q, q_labels,
                                              R=-1, PRs=(1, 5, 10),
                                              device=dev),
        "mAP R=[10, 100]": lambda dev: calculate_mAP(
            db, db_labels, q, q_labels, R=[10, 100], PRs=(1, 5, 10),
            device=dev),
        "PR curve": lambda dev: calculate_pr_curve(db, db_labels, q,
                                                   q_labels, device=dev),
    }
    worst = 0.0
    for name, fn in calls.items():
        t0 = time.perf_counter()
        got = fn(device)
        sec = time.perf_counter() - t0
        want = fn("cpu")
        flat_g = [float(x) for x in _flatten(got)]
        flat_w = [float(x) for x in _flatten(want)]
        err = max(abs(a - b) for a, b in zip(flat_g, flat_w))
        worst = max(worst, err)
        print(f"scoring {name} ({codes.shape[0]} queries, {sizes.scoring_db} "
              f"database codes, {nclass} classes): card {flat_g[:4]} vs CPU "
              f"{flat_w[:4]}, max |d| {err:.3g} over {len(flat_g)} numbers, "
              f"{sec * 1e3:.1f} ms on the card")
        if len(flat_g) != len(flat_w) or not err <= SCORING_ATOL:
            fail(f"scoring {name}: card and CPU differ by {err}")

    # the eval's own size, on the card only: seeded codes and labels
    nq, ndb = sizes.scoring_split
    gen = torch.Generator(device=device).manual_seed(37)
    nbit = codes.shape[1]
    sq = torch.randn(nq, nbit, generator=gen, device=device)
    sdb = torch.randn(ndb, nbit, generator=gen, device=device)
    sql = torch.randint(0, nclass, (nq,), generator=gen, device=device)
    sdbl = torch.randint(0, nclass, (ndb,), generator=gen, device=device)
    split = {
        "mAP R=-1, PRs (1, 5, 10)": lambda: calculate_mAP(
            sdb, sdbl, sq, sql, R=-1, PRs=(1, 5, 10), device=device),
        "PR curve": lambda: calculate_pr_curve(sdb, sdbl, sq, sql,
                                               device=device)[:2],
    }
    for name, fn in split.items():
        sec = host_s(fn, 2)
        vals = [float(x) for x in _flatten(fn())]
        print(f"scoring at the CUB-200 split size, {name} ({nq} queries, "
              f"{ndb} database codes, {nclass} classes, seeded codes): "
              f"{sec * 1e3:.1f} ms on the card, {len(vals)} numbers")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
            fail(f"scoring at the split size, {name}: a value outside [0, 1]")


# ---------------------------------------------------------------------------
# the CLIP text tower and the flagship run
# ---------------------------------------------------------------------------

def run_text_tower(sizes: Sizes, device) -> None:
    """Phase 13: the CLIP text tower (random weights from seed 0) on
    ``sizes.prompts`` seeded prompts of the full context, an eos in each, at
    float32 on the card against the same tower on the CPU."""
    from concepthash_tpu_torch.models.clip import (ClipTextConfig,
                                                   ClipTextTower)

    cfg = ClipTextConfig(**sizes.text)
    tower = ClipTextTower(cfg, device=device,
                          generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(41)
    n, L = sizes.prompts, cfg.max_position_embeddings
    ids = torch.randint(0, cfg.eos_token_id, (n, L), generator=gen)
    eos = torch.randint(1, L, (n,), generator=gen)
    ids[torch.arange(n), eos] = cfg.eos_token_id
    with torch.inference_mode():
        sec = host_s(lambda: tower(input_ids=ids.to(device)), 3)
        got = tower(input_ids=ids.to(device))
        # the slip TEXT_ATOL must catch: the same products in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32 = tower(input_ids=ids.to(device))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        cpu = tower.to("cpu")
        t0 = time.perf_counter()
        want = cpu(input_ids=ids)
        cpu_s = time.perf_counter() - t0
    errs = {k: (got[k].cpu() - want[k]).abs().max().item()
            for k in ("pooled", "text_embeds")}
    errs_tf32 = {k: (got_tf32[k].cpu() - want[k]).abs().max().item()
                 for k in errs}
    print(f"text tower ({cfg.num_layers} layers, width {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, {n} prompts x {L} ids, float32): "
          f"{sec * 1e3:.2f} ms on the card ({n / sec:.1f} prompts/s), "
          f"{cpu_s:.2f} s on the CPU; card vs CPU max |d| pooled "
          f"{errs['pooled']:.3g}, text_embeds {errs['text_embeds']:.3g} "
          f"(tolerance {TEXT_ATOL}); with TF32 matmuls pooled "
          f"{errs_tf32['pooled']:.3g}, text_embeds "
          f"{errs_tf32['text_embeds']:.3g}")
    if got["text_embeds"].shape != (n, cfg.projection_dim) or \
            not all(torch.isfinite(got[k]).all() for k in errs):
        fail("text tower: outputs not finite of the expected shape")
    if max(errs.values()) > TEXT_ATOL:
        fail(f"text tower: card and CPU differ by {errs}")


def run_flagship(sizes: Sizes, device) -> None:
    """Phase 14: main_gpu's flagship run (dataset=cub200 model=concepthash
    compute_dtype=bfloat16, 2 epochs, an evaluation after each) on a
    synthetic set of ``sizes.flagship_classes`` classes written by the
    port's maker, with the launch counts from zero; then the checks, a
    reload of models/last.pt, and the timings."""
    import os
    import tempfile

    import main_gpu
    from concepthash_tpu_torch.data.preprocess import preprocess_batch
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset
    from concepthash_tpu_torch.train.optim import current_lr

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        n_train, n_test = sizes.flagship_per_class
        t0 = time.perf_counter()
        make_synthetic_dataset(os.path.join(tmp, "synth"),
                               nclass=sizes.flagship_classes,
                               per_class_train=n_train,
                               per_class_test=n_test,
                               image_size=sizes.flagship_image, seed=0)
        write_s = time.perf_counter() - t0
        logdir = os.path.join(tmp, "run")

        def argv(*extra):
            # one step a dispatch (phase 15 runs several)
            args = ["dataset=cub200", "model=concepthash", f"data_dir={tmp}",
                    "dataset.data_folder=synth", "compute_dtype=bfloat16",
                    "epochs=2", "eval_interval=1", "train_chunk=1", *extra,
                    *sizes.flagship_args]
            return (args if device.type == "cuda"
                    else ["--device", str(device), *args])

        exp = main_gpu.build_experiment(argv(f"logdir={logdir}"))
        torch.cuda.synchronize()

        # ---- the main path, with the launch counts from zero ----
        count_reset()
        t0 = time.perf_counter()
        best = exp.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()

        # ---- what came out ----
        with open(os.path.join(logdir, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(logdir, "test_history.json")) as f:
            test = json.load(f)
        with open(os.path.join(logdir, "log.txt")) as f:
            log = f.read()
        files = ["config.yaml", "log.txt", "train_history.json",
                 "test_history.json", "models/best.pt", "models/last.pt",
                 "outputs/test_best.pt", "outputs/db_best.pt"]
        if exp.config.get("wandb"):
            files.append("events.jsonl")
        missing = [f for f in files
                   if not os.path.exists(os.path.join(logdir, f))]
        loaders = exp.loaders
        steps = len(loaders["train"])
        batch = int(exp.config["batch_size"])
        eval_batches = len(loaders["test"]) + len(loaders["db"])
        n_layers = exp.model.vision_cfg.num_layers
        want = (2 * n_layers * eval_batches, 0, 0, 0, 0, 0)
        lrs = [current_lr(exp.config["optim"], exp.config["scheduler"], 2,
                          steps, steps * (ep + 1)) for ep in range(2)]
        print(f"flagship run: {len(exp.datasets['train'])} train, "
              f"{len(exp.datasets['test'])} test, {len(exp.datasets['db'])} "
              f"database images of {sizes.flagship_image}^2 "
              f"({exp.config['dataset']['nclass']} classes, written in "
              f"{write_s:.1f} s); {steps} steps of {batch} an epoch; "
              f"codebook {tuple(exp.codebook.shape)}; best mAP {best}")
        print("flagship train records: " + "; ".join(
            f"ep {r['ep']} loss {r['loss']:.5f} lr {r['lr']:.6g} "
            f"{r['time']:.2f} s" for r in train))
        print("flagship test records: " + "; ".join(
            f"ep {r['ep']} mAP {r['mAP']:.6f} recalls "
            f"{[round(x, 4) for x in r['recalls']]} precisions "
            f"{[round(x, 4) for x in r['precisions']]}" for r in test))
        print(f"flagship launches (encoder_layer, subblock_mins packed, "
              f"plain, ln_matmul, attention, bitplane_mins): {launches}; "
              f"expected {want} ({n_layers} layers x {eval_batches} eval "
              f"batches x 2 evaluations)")
        if missing:
            fail(f"flagship run directory lacks {missing}")
        if len(train) != 2 or not all(math.isfinite(r["loss"])
                                      for r in train):
            fail("flagship: not two train records with a finite loss")
        if [r["lr"] for r in train] != lrs:
            fail(f"flagship lr {[r['lr'] for r in train]} != current_lr "
                 f"{lrs}")
        if len(test) != 2 or not all(
                0.0 <= r["mAP"] <= 1.0 and len(r["recalls"]) == 3
                and len(r["precisions"]) == 3 for r in test):
            fail("flagship: not two test records with mAP in [0, 1] and "
                 "the recalls and precisions")
        cb_shape = (exp.config["model"]["nclass"],
                    exp.model.vision_cfg.projection_dim)
        if exp.codebook.shape != cb_shape or "offline fallback" not in log \
                or "pseudo-embeddings" not in log:
            fail(f"flagship: the codebook is not the offline fallback's "
                 f"{cb_shape}, or its warning is not in log.txt")
        if launches != want:
            fail("flagship: kernel 1 not launched 12 times an eval batch, "
                 "or another kernel launched")

        # ---- models/last.pt reloads to the same codes ----
        codes = exp.encode_split("test")[0]["codes"]
        fresh = main_gpu.build_experiment(argv(
            f"logdir={logdir}_reload",
            f"finetune_path={logdir}/models/last.pt"))
        same = torch.equal(fresh.encode_split("test")[0]["codes"], codes)
        print(f"flagship: models/last.pt reloaded encodes the test split to "
              f"the same codes, bit for bit: {same}")
        if not same:
            fail("flagship: the reloaded model's codes differ")
        del fresh

        # ---- the eval codes against the kernel's plain version ----
        kernel_codes = {"test": codes,
                        "db": exp.encode_split("db")[0]["codes"]}
        with plain_layers():
            plain = {k: exp.encode_split(k)[0]["codes"] for k in kernel_codes}
        agree = {k: ((kernel_codes[k] > 0) == (plain[k] > 0)).float().mean()
                 .item() for k in plain}
        print(f"flagship eval codes vs an encode through the layer's plain "
              f"version: sign agreement test {agree['test']:.6f}, database "
              f"{agree['db']:.6f} (batches of {batch} and the tails of "
              f"{len(exp.datasets['test']) % batch} and "
              f"{len(exp.datasets['db']) % batch})")
        if min(agree.values()) < MIN_SIGN_AGREEMENT:
            fail(f"flagship: eval codes agree in sign with the plain "
                 f"encode on {agree} < {MIN_SIGN_AGREEMENT}")

        # ---- timings (host clock, synchronized) ----
        n_eval = len(exp.datasets["test"]) + len(exp.datasets["db"])
        enc_s = host_s(lambda: (exp.encode_split("test"),
                                exp.encode_split("db")), 1)
        epoch_s = train[1]["time"]
        print(f"flagship: train {steps * batch / epoch_s:.1f} img/s in epoch "
              f"2 ({epoch_s:.2f} s, data, augmentation and copies included); "
              f"eval encode {n_eval / enc_s:.1f} img/s ({n_eval} images, "
              f"{enc_s:.2f} s); the run {run_s:.1f} s")
        # where an epoch's time goes: the loader alone (decode, stack), the
        # on-card preprocessing of one batch, the bare train and eval steps
        loader_s = {k: host_s(lambda: sum(1 for _ in exp.loaders[k]), 1)
                    for k in ("train", "test", "db")}
        raw = next(iter(exp.loaders["train"]))
        images = exp._on_device(raw["image"])
        labels = exp._on_device(raw["label"])
        pre_s = host_s(lambda: preprocess_batch(
            images, exp.aug_generator, crop=exp.crop, norm=exp.norm,
            train=True, augment=exp.augment,
            op_generator=exp.op_generator), 5)
        x = preprocess_batch(images, crop=exp.crop, norm=exp.norm)
        step_s = host_s(lambda: exp.train_step({"image": x, "label": labels}),
                        5)
        eval_s = host_s(lambda: exp.eval_step({"image": x, "label": labels}),
                        5)
        print(f"flagship epoch parts (host clock, batch {batch}): loader "
              f"alone {loader_s['train']:.2f} s a train epoch ("
              f"{steps * batch / loader_s['train']:.1f} img/s), "
              f"{loader_s['test'] + loader_s['db']:.2f} s over test + db ("
              f"{n_eval / (loader_s['test'] + loader_s['db']):.1f} img/s); "
              f"crop + flip + TrivialAugment + normalize {pre_s * 1e3:.2f} "
              f"ms a batch; train step {step_s * 1e3:.2f} ms; eval step "
              f"{eval_s * 1e3:.2f} ms")
        t0 = time.perf_counter()
        kernels = device_breakdown("flagship train epoch",
                                   lambda: exp.train_one_epoch(2), epoch_s,
                                   rows=8, warm=False)
        print(f"flagship: traced epoch took {time.perf_counter() - t0:.1f} s")
        for loader in exp.loaders.values():
            loader.close()
    print(f"flagship phase: {time.perf_counter() - t_phase:.1f} s")
    return {"train_img_s": steps * batch / epoch_s, "epoch_s": epoch_s,
            "busy": busy_share(kernels, epoch_s), "steps": steps}


def busy_share(kernels, wall_s: float) -> float:
    """The device's busy share in a traced run (``device_breakdown``'s
    kernels) over ``wall_s``."""
    return sum(us for _, us, _ in kernels) / 1e6 / wall_s


# ---------------------------------------------------------------------------
# phase 15: several steps per dispatch, resume, eval-only, local weights
# ---------------------------------------------------------------------------

def stacked_batches(sizes: Sizes, vcfg, nclass: int, chunks: int, device,
                    seed: int, side: int = 0, views: int = 1,
                    aux: bool = False):
    """``chunks`` chunks of ``sizes.graph_chunk`` seeded batches of
    ``sizes.train_batch`` center-cropped, normalized images (``views`` times
    as many image rows: a two-view method's) and one-hot labels, with a
    seeded (B, B) int8 structure block as ``aux`` where asked: (the
    batches, the chunks stacked (K, ...))."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize

    gen = torch.Generator(device=device).manual_seed(seed)
    K, B = sizes.graph_chunk, sizes.train_batch
    batches = []
    for _ in range(chunks * K):
        raw = torch.randint(0, 256, (views * B, side or sizes.image_side,
                                     side or sizes.image_side, 3),
                            generator=gen, device=device, dtype=torch.uint8)
        y = torch.randint(0, nclass, (B,), generator=gen, device=device)
        batches.append({"image": normalize(center_crop(raw, vcfg.image_size),
                                           3),
                        "label": F.one_hot(y, nclass).float()})
        if aux:
            batches[-1]["aux"] = torch.randint(
                -1, 2, (B, B), generator=gen, device=device).to(torch.int8)
    stacked = [{k: torch.stack([b[k] for b in batches[c * K:(c + 1) * K]])
                for k in batches[0]} for c in range(chunks)]
    return batches, stacked


def graph_vs_eager_train(sizes: Sizes, device, vision,
                         optim: dict | None = None, over: dict | None = None,
                         label: str = "") -> tuple:
    """Phase 15 (a): copies of one model and optimizer state (the canonical
    config at B=32, dropout 0); 2K steps through ``make_multi_train_step``
    (a warm-up chunk, then a graph replay) and 2K eager steps of
    ``make_train_step`` on the same batches, held per step bit for bit: the
    eager copy is the optimizer a run at ``train_chunk=1`` builds (on the
    card capturable, with the float32 rates a chunk reads: one arithmetic
    for every step). Returns the graph's training and runner. ``optim``
    replaces the config's adam; ``over`` updates config groups (phase 16's
    variants, named ``label``); the state dicts compared include the
    buffers (running statistics, FILIP's token embeddings)."""
    from concepthash_tpu_torch.methods import build_training
    from concepthash_tpu_torch.train.optim import current_lr
    from concepthash_tpu_torch.train.state import make_multi_train_step

    cfg = variant_config(sizes, **(over or {}))
    cfg["model"]["upt_config"]["dropout"] = 0.0
    if optim:
        cfg["optim"] = dict(optim)
    nclass = cfg["model"]["nclass"]
    centers = torch.randn(nclass, sizes.head.get("center_dim", 512),
                          generator=torch.Generator().manual_seed(0))
    graph, eager = [build_training(cfg, centers, sizes.steps_per_epoch,
                                   device=device, vision=vision)
                    for _ in range(2)]
    eager.model.load_state_dict(graph.model.state_dict())
    vcfg = graph.model.vision_cfg
    batches, stacked = stacked_batches(sizes, vcfg, nclass, 2, device, 23)
    multi = make_multi_train_step(graph.model, graph.loss_fn, graph.optimizer,
                                  graph.scheduler, generator=graph.generator)
    torch.cuda.synchronize()
    count_reset()
    g_loss, lrs = [], []
    for chunk in stacked:
        g_loss += multi(chunk)["loss"].tolist()
        lrs += multi.last_lrs.tolist()
    torch.cuda.synchronize()
    launches = counts()
    e_loss = [float(eager.step(b)["loss"]) for b in batches]
    want_lr = [current_lr(cfg["optim"], cfg["scheduler"], cfg["epochs"],
                          sizes.steps_per_epoch, s)
               for s in range(len(batches))]
    # every step, chunked or single, on the card or the CPU, reads the
    # float32 rate of the schedule
    lr_ok = lrs == want_lr
    rel = max(abs(g - e) / abs(e) for g, e in zip(g_loss, e_loss))
    gp, ep = graph.model.state_dict(), eager.model.state_dict()
    d_param = max((gp[k].float() - ep[k].float()).abs().max().item()
                  for k in gp)
    same = g_loss == e_loss and d_param == 0.0
    name = ("pallas" if vision else "auto") + (
        f", {cfg['optim']['name']}" if optim else "") + (
        f", {label}" if label else "")
    n_lay = vcfg.num_layers
    K = sizes.graph_chunk
    print(f"graph vs eager train ({name}, K={K}, B={sizes.train_batch}, 2 "
          f"chunks: a warm-up, then a replay): losses graph "
          + ", ".join(f"{x:.5f}" for x in g_loss[K:]) + " / eager "
          + ", ".join(f"{x:.5f}" for x in e_loss[K:])
          + f" (replayed chunk); max rel |d| {rel:.3g}, parameters max |d| "
          f"{d_param:.3g}: bit for bit {same} (required); "
          f"per-step lr equals current_lr: {lr_ok} "
          f"({lrs[0]:.6g} .. {lrs[-1]:.6g}); replays "
          f"{getattr(multi, 'replays', 0)}, launches per replay "
          f"{getattr(multi, 'launches_per_replay', None)}, counted "
          f"{launches}")
    if not all(math.isfinite(x) for x in g_loss) or not same:
        fail(f"graphed train steps ({name}) differ from eager ones: losses "
             f"rel {rel}, parameters {d_param}")
    if not lr_ok:
        fail(f"graphed steps' lr {lrs} != current_lr {want_lr}")
    if vision:
        want = (0, 0, 0, 2 * K * 2 * n_lay, 2 * K * n_lay, 0)
        if launches != want:
            fail(f"kernels 5 and 6 in the graph: launches {launches} != "
                 f"{want}")
        if device.type == "cuda" and multi.launches_per_replay != {
                "ln_matmul_cuda": K * 2 * n_lay, "attention_cuda": K * n_lay}:
            fail(f"launches per replay {multi.launches_per_replay}")
    del eager
    return graph, multi


def graph_dropout(sizes: Sizes, device) -> None:
    """Phase 15 (a), dropout 0.1: three chunks on the same batches (a
    warm-up, two replays); the dropout generator advances every chunk and
    the loss stays finite and falls. An eager twin from the same generator
    seed (and the same capturable optimizer) is printed beside it: equal
    losses mean each replay drew the masks that eager steps draw."""
    from concepthash_tpu_torch.methods import build_training
    from concepthash_tpu_torch.train.state import make_multi_train_step

    cfg = train_config(sizes)
    nclass = cfg["model"]["nclass"]
    centers = torch.randn(nclass, sizes.head.get("center_dim", 512),
                          generator=torch.Generator().manual_seed(0))
    tr = build_training(cfg, centers, sizes.steps_per_epoch, device=device)
    twin = build_training(cfg, centers, sizes.steps_per_epoch, device=device)
    twin.model.load_state_dict(tr.model.state_dict())
    batches, stacked = stacked_batches(sizes, tr.model.vision_cfg, nclass, 1,
                                       device, 29)
    multi = make_multi_train_step(tr.model, tr.loss_fn, tr.optimizer,
                                  tr.scheduler, generator=tr.generator)
    states = [tr.generator.get_state()]
    means, losses = [], []
    for _ in range(3):
        loss = multi(stacked[0])["loss"]
        states.append(tr.generator.get_state())
        losses += loss.tolist()
        means.append(loss.mean().item())
    twin_loss = [float(twin.step(b)["loss"]) for _ in range(3)
                 for b in batches]
    advanced = all(not torch.equal(a, b) for a, b in zip(states, states[1:]))
    rel = max(abs(g - e) / abs(e) for g, e in zip(losses, twin_loss))
    print(f"graph train, dropout 0.1 (3 chunks of {sizes.graph_chunk} on the "
          f"same batches): mean loss per chunk "
          + ", ".join(f"{x:.5f}" for x in means)
          + f"; the dropout generator advanced every chunk: {advanced}; "
          f"against an eager twin from the same seed: max rel |d| {rel:.3g}")
    if not advanced:
        fail("the dropout generator did not advance over a replay")
    if not all(math.isfinite(x) for x in losses) or means[-1] >= means[0]:
        fail(f"graph train with dropout: loss {means} not finite or not "
             "falling")


def graph_vs_eager_eval(sizes: Sizes, device, tr) -> None:
    """Phase 15 (b): the multi eval step's codes (kernel 1 inside the graph
    at B=32) against the eager eval step's, bit for bit."""
    from concepthash_tpu_torch.train.state import (make_eval_step,
                                                   make_multi_eval_step)

    model = tr.model
    nclass = model.cfg.nclass
    batches, stacked = stacked_batches(sizes, model.vision_cfg, nclass, 1,
                                       device, 31, sizes.flagship_image)
    multi = make_multi_eval_step(model, tr.loss_fn)
    multi(stacked[0])                       # the warm-up
    torch.cuda.synchronize()
    count_reset()
    codes, metrics = multi(stacked[0])      # capture, then a replay
    torch.cuda.synchronize()
    launches = counts()[0]
    step = make_eval_step(model, tr.loss_fn)
    eager = [step(b) for b in batches]
    same = all(torch.equal(codes["codes"][k], c["codes"])
               for k, (c, _) in enumerate(eager))
    same_loss = all(torch.equal(metrics["loss"][k], m["loss"])
                    for k, (_, m) in enumerate(eager))
    n_lay, K = model.vision_cfg.num_layers, sizes.graph_chunk
    per_replay = getattr(multi, "launches_per_replay", {}).get(
        "encoder_layer_cuda")
    print(f"graph vs eager eval (K={K}, B={sizes.train_batch}): codes equal "
          f"bit for bit: {same}, losses: {same_loss}; kernel 1 launches per "
          f"replay {per_replay} (expected {K * n_lay}), counted {launches}")
    if not (same and same_loss) or launches != K * n_lay:
        fail("multi eval step: codes differ from the eager eval step's, or "
             "kernel 1 not launched 12 times a batch")
    if device.type == "cuda" and per_replay != K * n_lay:
        fail(f"kernel 1 launches per replay {per_replay} != {K * n_lay}")


def synthetic_bpe(prompts, vocab_size: int, n_merges: int = 300):
    """A CLIP-style vocabulary and merges learned from ``prompts``: the 256
    byte symbols and their word ends, then greedy merges, with
    ``<|startoftext|>`` and ``<|endoftext|>`` at the last two ids."""
    from concepthash_tpu_torch.models.tokenizer import (bytes_to_unicode,
                                                        normalize,
                                                        pre_tokenize)

    base = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(base + [c + "</w>" for c in base])}
    words = []
    for p in prompts:
        for piece in pre_tokenize(normalize(p)):
            sym = [bytes_to_unicode()[b] for b in piece.encode()]
            words.append(sym[:-1] + [sym[-1] + "</w>"])
    merges = []
    while len(merges) < n_merges and len(vocab) < vocab_size - 2:
        pairs = {}
        for w in words:
            for pair in zip(w, w[1:]):
                pairs[pair] = pairs.get(pair, 0) + 1
        if not pairs:
            break
        a, b = max(pairs, key=lambda p: (pairs[p], p))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        out = []
        for w in words:
            m, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    m.append(a + b)
                    i += 2
                else:
                    m.append(w[i])
                    i += 1
            out.append(m)
        words = out
    vocab["<|startoftext|>"] = vocab_size - 2
    vocab["<|endoftext|>"] = vocab_size - 1
    return vocab, merges


def write_hf_clip(path: str, vision, text, prompts) -> None:
    """A CLIP checkpoint in Hugging Face's layout from the port's towers:
    ``config.json``, ``pytorch_model.bin`` (HF key names: OIHW patch
    convolution, separate q, k, v, ``pre_layrnorm``), and a synthetic
    ``vocab.json`` and ``merges.txt``."""
    import os

    vc, tc = vision.cfg, text.cfg
    if vc.projection_dim != tc.projection_dim:
        raise ValueError("a CLIPModel projects both towers to one width")
    sd = {}
    v, p = vision.state_dict(), "vision_model"
    sd[f"{p}.embeddings.patch_embedding.weight"] = \
        v["patch_embedding.weight"].permute(3, 2, 0, 1)
    sd[f"{p}.embeddings.class_embedding"] = v["class_embedding"]
    sd[f"{p}.embeddings.position_embedding.weight"] = v["position_embedding"]
    for src, dst in (("pre_layernorm", "pre_layrnorm"),
                     ("post_layernorm", "post_layernorm")):
        for kind in ("weight", "bias"):
            sd[f"{p}.{dst}.{kind}"] = v[f"{src}.{kind}"]
    for i in range(vc.num_layers):
        s, d = f"layers.{i}", f"{p}.encoder.layers.{i}"
        for kind in ("weight", "bias"):
            for n in ("layer_norm1", "layer_norm2"):
                sd[f"{d}.{n}.{kind}"] = v[f"{s}.{n}.{kind}"]
            q, k, vv = v[f"{s}.self_attn.qkv_proj.{kind}"].chunk(3)
            for n, t in (("q_proj", q), ("k_proj", k), ("v_proj", vv)):
                sd[f"{d}.self_attn.{n}.{kind}"] = t
            sd[f"{d}.self_attn.out_proj.{kind}"] = \
                v[f"{s}.self_attn.out_proj.{kind}"]
            for n in ("fc1", "fc2"):
                sd[f"{d}.mlp.{n}.{kind}"] = v[f"{s}.{n}.{kind}"]
    sd["visual_projection.weight"] = v["visual_projection.weight"]
    t, p = text.state_dict(), "text_model"
    sd[f"{p}.embeddings.token_embedding.weight"] = t["token_embedding"]
    sd[f"{p}.embeddings.position_embedding.weight"] = t["position_embedding"]
    for kind in ("weight", "bias"):
        sd[f"{p}.final_layer_norm.{kind}"] = t[f"final_layer_norm.{kind}"]
    for i in range(tc.num_layers):
        s, d = f"layers.{i}", f"{p}.encoder.layers.{i}"
        for kind in ("weight", "bias"):
            for n in ("layer_norm1", "layer_norm2"):
                sd[f"{d}.{n}.{kind}"] = t[f"{s}.{n}.{kind}"]
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{d}.self_attn.{n}.{kind}"] = t[f"{s}.{n}.{kind}"]
            for n in ("fc1", "fc2"):
                sd[f"{d}.mlp.{n}.{kind}"] = t[f"{s}.{n}.{kind}"]
    sd["text_projection.weight"] = t["text_projection.weight"]
    sd["logit_scale"] = torch.tensor(2.6592)
    os.makedirs(path, exist_ok=True)
    torch.save({k: x.detach().cpu().contiguous().clone()
                for k, x in sd.items()},
               os.path.join(path, "pytorch_model.bin"))
    config = {
        "architectures": ["CLIPModel"], "projection_dim": vc.projection_dim,
        "vision_config": {
            "hidden_size": vc.hidden_size,
            "intermediate_size": vc.intermediate_size,
            "num_hidden_layers": vc.num_layers,
            "num_attention_heads": vc.num_heads,
            "image_size": vc.image_size, "patch_size": vc.patch_size,
            "hidden_act": vc.hidden_act, "layer_norm_eps": vc.layer_norm_eps},
        "text_config": {
            "hidden_size": tc.hidden_size,
            "intermediate_size": tc.intermediate_size,
            "num_hidden_layers": tc.num_layers,
            "num_attention_heads": tc.num_heads,
            "max_position_embeddings": tc.max_position_embeddings,
            "vocab_size": tc.vocab_size, "hidden_act": tc.hidden_act,
            "layer_norm_eps": tc.layer_norm_eps,
            "eos_token_id": tc.eos_token_id},
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    vocab, merges = synthetic_bpe(prompts, tc.vocab_size)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def run_pretrained(sizes: Sizes, device, tmp: str, argv) -> str:
    """Phase 15 (d): random towers (seeds 5 and 6) written as a local HF
    CLIP checkpoint; the flagship built with ``backbone.name=<dir>``.
    Returns the checkpoint's directory."""
    import os

    import main_gpu
    from concepthash_tpu_torch.data.manifest import read_class_names
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_training
    from concepthash_tpu_torch.models.clip import (ClipTextConfig,
                                                   ClipTextTower,
                                                   ClipVisionTower)
    from concepthash_tpu_torch.train import codebook as tcb

    probe = main_gpu.build_experiment(argv(os.path.join(tmp, "probe"),
                                           "epochs=1"))
    vcfg = probe.model.vision_cfg
    prefix = probe.config["model"]["fixed_center"].get("prompt_prefix",
                                                       "a photo of a ")
    for loader in probe.loaders.values():
        loader.close()
    del probe
    names = read_class_names(os.path.join(tmp, "synth"))
    prompts = [f"{prefix}{n}" for n in names]
    tcfg = ClipTextConfig(**sizes.hf_text)
    vision = ClipVisionTower(vcfg, None,
                             generator=torch.Generator().manual_seed(5))
    text = ClipTextTower(tcfg, device="cpu",
                         generator=torch.Generator().manual_seed(6))
    hf_dir = os.path.join(tmp, "clip-local")
    write_hf_clip(hf_dir, vision, text, prompts)
    del text

    logdir = os.path.join(tmp, "pretrained")
    t0 = time.perf_counter()
    exp = main_gpu.build_experiment(argv(logdir, "epochs=1",
                                         f"backbone.name={hf_dir}",
                                         "backbone.pretrained=true"))
    build_s = time.perf_counter() - t0
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    own = exp.model.backbone.state_dict()
    src = vision.state_dict()
    same_tower = all(torch.equal(own[k].cpu(), v) for k, v in src.items())
    # the source model: a fresh build of the same config (its head and
    # adapters), with the written tower loaded directly
    source = build_training(exp.config, exp.codebook, exp.steps_per_epoch,
                            device=device).model
    source.backbone.load_state_dict(src, strict=False)
    gen = torch.Generator(device=device).manual_seed(37)
    side = sizes.flagship_image
    raw = torch.randint(0, 256, (sizes.pretrained_images, side, side, 3),
                        generator=gen,
                        device=device, dtype=torch.uint8)
    images = normalize(center_crop(raw, vcfg.image_size), 3)
    with torch.inference_mode():
        codes = exp.model(images)["codes"]
        want = source(images)["codes"]
    same_codes = torch.equal(codes, want)
    cpu_cb = tcb.embed_class_names(names, hf_dir, prompt_prefix=prefix,
                                   device="cpu")
    err = float(np.abs(np.asarray(exp.codebook) - cpu_cb).max())
    text_stage = ("offline fallback" not in log and
                  f"CLIP text tower of {hf_dir}" in log)
    print(f"pretrained from a local directory ({len(src)} vision tensors, "
          f"text {tcfg.num_layers} layers x {tcfg.hidden_size}, vocab "
          f"{tcfg.vocab_size}; built in {build_s:.1f} s): vision tower "
          f"equal to the written one bit for bit: {same_tower}; "
          f"{sizes.pretrained_images} images encode to the source model's "
          f"codes bit for bit: {same_codes}; the codebook "
          f"{tuple(np.shape(exp.codebook))} from the real text stage on "
          f"{device.type}: {text_stage}, max |d| against the CPU's "
          f"{err:.3g} (tolerance {TEXT_ATOL})")
    for loader in exp.loaders.values():
        loader.close()
    if not (same_tower and same_codes):
        fail("the local checkpoint's vision tower was not loaded as written")
    if not text_stage or err > TEXT_ATOL:
        fail("the codebook did not take the local text stage, or differs "
             f"from the CPU's by {err}")
    return hf_dir


def eval_only_modes(label: str, run: str, test: list, eval_argv) -> None:
    """Phase 15 (c) and 16 (c): on a finished 2-epoch run directory,
    ``exp=validation use_last=true`` reproduces the run's last mAP and
    ``exp=extract`` writes its best test codes bit for bit."""
    import os

    import main_gpu

    ev = main_gpu.build_experiment(eval_argv(
        "exp=validation", f"logdir={run}", "use_last=true"))
    got = ev.main()
    d_map = abs(got["mAP"] - test[-1]["mAP"])
    ex = main_gpu.build_experiment(eval_argv("exp=extract", f"logdir={run}"))
    ex.main()
    out = torch.load(os.path.join(ex.eval_logdir, "outputs.pt"))
    best = torch.load(os.path.join(run, "outputs", "test_best.pt"))
    same = torch.equal(out["test"]["codes"], best["codes"])
    print(f"{label} exp=validation use_last=true: mAP {got['mAP']:.6f} "
          f"against the run's last {test[-1]['mAP']:.6f} (|d| {d_map:.3g}, "
          f"tolerance {REPLAY_MAP_ATOL}); exp=extract writes the run's "
          f"best test codes {tuple(out['test']['codes'].shape)} bit for "
          f"bit: {same}")
    if d_map > REPLAY_MAP_ATOL or not same:
        fail(f"{label}: the eval-only modes do not reproduce the run")


def check_resume(label: str, tmp: str, run: str, train: list, argv, *extra,
                 extras: tuple = ()) -> None:
    """Phases 15 (c), 16 (c) and 20 (c): a run stopped after epoch 1 and
    resumed reaches the finished 2-epoch run's epoch-2 train loss, its last
    parameters and the method's ``extras`` (named entries of the train
    state's ``extra`` in ``optims/last.pt``, as moco's teacher) bit for
    bit."""
    import os

    import main_gpu

    first_dir = os.path.join(tmp, os.path.basename(run) + "_first")
    res_dir = os.path.join(tmp, os.path.basename(run) + "_resumed")
    first = main_gpu.build_experiment(argv(first_dir, *extra))
    first.epochs = 1
    first.main()
    resumed = main_gpu.build_experiment(argv(
        res_dir, *extra, f"resume_logdir={first_dir}"))
    resumed.main()
    with open(os.path.join(res_dir, "train_history.json")) as f:
        res_train = json.load(f)
    rel = abs(res_train[-1]["loss"] - train[-1]["loss"]) / abs(
        train[-1]["loss"])

    def max_d(kind, key, name=None):
        a, b = (torch.load(os.path.join(r, kind, "last.pt"))[key]
                for r in (run, res_dir))
        if name is not None:
            a, b = a[name], b[name]
        return max((a[k].float() - b[k].float()).abs().max().item()
                   for k in a)

    d = {"last parameters": max_d("models", "model"),
         **{name: max_d("optims", "extra", name) for name in extras}}
    same = res_train[-1]["loss"] == train[-1]["loss"] and \
        all(v == 0 for v in d.values())
    print(f"{label} resumed after epoch 1: epoch-2 train loss "
          f"{res_train[-1]['loss']:.6f} against the uninterrupted "
          f"{train[-1]['loss']:.6f} (rel {rel:.3g}), "
          + ", ".join(f"{k} max |d| {v:.3g}" for k, v in d.items())
          + f": bit for bit {same} (required); records {len(res_train)}")
    if len(res_train) != 2 or not same:
        fail(f"{label}: the resumed run does not reach the uninterrupted "
             "one bit for bit")


def run_graphs(sizes: Sizes, device, flagship: dict) -> None:
    """Phase 15: several steps per dispatch (CUDA graphs) against eager
    steps, train and eval; the chunked flagship run with its eval-only
    modes and a resume; a local pretrained checkpoint."""
    import os
    import tempfile

    import main_gpu
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset

    t_phase = time.perf_counter()
    graph_vs_eager_train(sizes, device, None)
    tr, _ = graph_vs_eager_train(sizes, device, TRAIN_VISION)
    del tr
    graph_vs_eager_train(sizes, device, None, SGD_OPTIM)
    graph_dropout(sizes, device)
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        n_train, n_test = sizes.graph_per_class
        make_synthetic_dataset(os.path.join(tmp, "synth"),
                               nclass=sizes.flagship_classes,
                               per_class_train=n_train,
                               per_class_test=n_test,
                               image_size=sizes.flagship_image, seed=0)

        def argv(logdir, *extra):
            args = ["dataset=cub200", "model=concepthash", f"data_dir={tmp}",
                    "dataset.data_folder=synth", "compute_dtype=bfloat16",
                    "epochs=2", "eval_interval=1",
                    # auto is 8 on the card; the CPU rehearsal chunks too
                    "train_chunk=" + ("auto" if device.type == "cuda"
                                      else str(sizes.graph_chunk)),
                    "save_training_state=true", f"logdir={logdir}",
                    *sizes.flagship_args, *extra]
            return (args if device.type == "cuda"
                    else ["--device", str(device), *args])

        def eval_argv(*extra):
            args = [f"data_dir={tmp}", *extra]
            return (args if device.type == "cuda"
                    else ["--device", str(device), *args])

        run = os.path.join(tmp, "run")
        exp = main_gpu.build_experiment(argv(run))
        secs = time_encodes(exp)
        graph_vs_eager_eval(sizes, device, exp.training)
        # the main path of the phase, with the launch counts from zero
        torch.cuda.synchronize()
        count_reset()
        t0 = time.perf_counter()
        exp.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        with open(os.path.join(run, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(run, "test_history.json")) as f:
            test = json.load(f)
        steps = len(exp.loaders["train"])
        batch = int(exp.config["batch_size"])
        K = exp.train_chunk
        n_layers = exp.model.vision_cfg.num_layers
        eval_batches = len(exp.loaders["test"]) + len(exp.loaders["db"])
        want = (2 * n_layers * eval_batches, 0, 0, 0, 0, 0)
        runner = exp.train_multi_step
        print(f"chunked flagship run (train_chunk {K}): "
              f"{len(exp.datasets['train'])} train images, {steps} steps of "
              f"{batch} an epoch ({steps // K} chunks of {K} and "
              f"{steps % K} single steps); train records "
              + "; ".join(f"ep {r['ep']} loss {r['loss']:.5f} lr "
                          f"{r['lr']:.6g} {r['time']:.2f} s" for r in train)
              + "; test mAP " + ", ".join(f"{r['mAP']:.6f}" for r in test)
              + f"; graph replays {getattr(runner, 'replays', 0)} train, "
              f"{getattr(exp.eval_multi_step, 'replays', 0)} eval; launches "
              f"{launches}, expected {want}; the run {run_s:.1f} s")
        if K != sizes.graph_chunk:
            fail(f"train_chunk auto resolved to {K}")
        if len(train) != 2 or len(test) != 2 or not all(
                math.isfinite(r["loss"]) for r in train):
            fail("chunked flagship: not two finite train records and two "
                 "test records")
        if launches != want:
            fail("chunked flagship: kernel 1 not launched 12 times an eval "
                 "batch, or another kernel launched")
        if device.type == "cuda" and runner.replays != 2 * (steps // K) - 1:
            fail(f"chunked flagship: {runner.replays} train replays, "
                 f"expected {2 * (steps // K) - 1}")

        # ---- the eval-only modes and a resume on the run directory ----
        eval_only_modes("flagship", run, test, eval_argv)
        check_resume("flagship", tmp, run, train, argv)

        # ---- one step a dispatch on the same set: the same run (F2) ----
        one = main_gpu.build_experiment(argv(os.path.join(tmp, "one"),
                                             "train_chunk=1"))
        one_train = [one.train_one_epoch(0), one.train_one_epoch(1)]
        one_s = one_train[1]["time"]
        last = torch.load(os.path.join(run, "models", "last.pt"))["model"]
        one_sd = one.model.state_dict()
        d_one = max((last[k].float().cpu() - one_sd[k].float().cpu())
                    .abs().max().item() for k in last)
        same_one = (all(a["loss"] == b["loss"]
                        for a, b in zip(one_train, train))
                    and d_one == 0.0 and set(last) == set(one_sd))
        print("train_chunk=1 against the chunked run on the same seed: "
              "epoch losses " + ", ".join(f"{r['loss']:.6f}"
                                          for r in one_train)
              + " against " + ", ".join(f"{r['loss']:.6f}" for r in train)
              + f", models/last.pt max |d| {d_one:.3g}: bit for bit "
              f"{same_one} (required)")
        if not same_one:
            fail("train_chunk=1 and train_chunk=auto differ on the same "
                 "seed (F2): one optimizer arithmetic is required")
        for loader in one.loaders.values():
            loader.close()
        del one

        # ---- timings beside phase 14's one step a dispatch ----
        epoch_s = train[1]["time"]
        kernels = device_breakdown("chunked flagship train epoch",
                                   lambda: exp.train_one_epoch(2), epoch_s,
                                   rows=8, warm=False)
        img_s = steps * batch / epoch_s
        n_eval, eval_rate = eval_img_s(exp, secs)
        chunked = {"train_img_s": img_s, "eval_img_s": eval_rate,
                   "busy": busy_share(kernels, epoch_s), "batch": batch,
                   "resize": int(exp.config["dataset"]["resize"])}
        print(f"flagship eval encode at train_chunk {K}: "
              f"{chunked['eval_img_s']:.1f} img/s (the second evaluation's "
              f"{n_eval} test images)")
        print(f"flagship train img/s in epoch 2: {img_s:.1f} at train_chunk "
              f"{K} against {steps * batch / one_s:.1f} at train_chunk 1 on "
              f"the same {steps} steps, and {flagship['train_img_s']:.1f} at "
              f"train_chunk 1 ({flagship['steps']} steps, phase 14); device "
              f"busy {100 * busy_share(kernels, epoch_s):.1f}% against "
              f"{100 * flagship['busy']:.1f}%; "
              f"{card_line() if device.type == 'cuda' else 'the CPU'}")
        for loader in exp.loaders.values():
            loader.close()
        del exp
        print(f"phase 15 (c): {time.perf_counter() - t_c:.1f} s")

        hf_dir = run_pretrained(sizes, device, tmp, argv)
        print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
        run_variant_runs(sizes, device, tmp, argv, eval_argv, hf_dir,
                         chunked)
        run_baseline_runs(device, tmp, argv, eval_argv, hf_dir, chunked)
        run_model_runs("phase 18 (c)", device, tmp, argv, eval_argv,
                       chunked, (
                           ("a2net_ce_adapter", {}),
                           ("semicon_ce_adapter", {"val_at_run_batch": True}),
                           # one SGD pass over the subset an epoch (the
                           # config's max_iters 3 cut for the script's time)
                           ("semicon", {"single": True,
                                        "extra": ("criterion.max_iters=1",)})))
        run_loader(sizes, device, tmp, argv, chunked)
        run_unsupervised_runs(sizes, device, tmp, argv, eval_argv, chunked)
        run_pretrain_runs(sizes, device, tmp, argv, eval_argv, chunked)
        run_trunk_runs(sizes, device, tmp, argv, eval_argv, chunked)


# ---------------------------------------------------------------------------
# phase 16: the other ConceptHash models and options
# ---------------------------------------------------------------------------

# configs/model/concepthash_sa.yaml's SelfAttentionAtLast, and every other
# option of it on
SA_YAML = {"params": True, "mask_sigma": 0.5, "cross_attention": False,
           "differentiable": False, "add_pe": False}
SA_FULL = {"params": True, "strong": True, "mask_sigma": 0.5,
           "cross_attention": True, "differentiable": True, "add_pe": True}
LARS_OPTIM = {"name": "lars", "lr": 0.1, "momentum": 0.9,
              "weight_decay": 0.0005}


def variant_config(sizes: Sizes, model: dict | None = None,
                   backbone: dict | None = None,
                   loss_scales: dict | None = None) -> dict:
    """``train_config`` with the groups updated by a variant's keys."""
    cfg = train_config(sizes)
    cfg["model"].update(model or {})
    cfg["backbone"].update(backbone or {})
    cfg["criterion"]["loss_scales"].update(loss_scales or {})
    return cfg


def filip_over(sizes: Sizes, seed: int = 43) -> dict:
    """FILIP with seeded class-text token embeddings (nclass, T, 512) and
    its loss on, as configs/model/concepthash_filip.yaml weighs it."""
    nclass = sizes.head["nclass"]
    proj = sizes.vision.get("projection_dim", 512)
    te = torch.randn(nclass, sizes.filip_tokens, proj,
                     generator=torch.Generator().manual_seed(seed)).numpy()
    return dict(model={"filip": True, "token_embeds_array": te},
                loss_scales={"filip_logits": 1})


def seed_adapters(model, gen) -> None:
    """Seeded values in every adapter's zero-init up-projection (the
    branch adapters and the q/k/v/out ones), so each changes the codes."""
    from concepthash_tpu_torch.models.clip import Adapter

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Adapter):
                m.up.weight.copy_(0.02 * torch.randn(m.up.weight.shape,
                                                     generator=gen))


def variant_forwards(sizes: Sizes, device) -> None:
    """Phase 16 (a): one model per option at full width, bf16, seeded
    weights, encodes ``sizes.variant_images`` seeded images on the card
    (the launch counts from zero) and its weights encode them at float32 on
    the CPU: codes finite, of shape (B, nbit), agreeing in sign on >= 99%
    of bits; kernel 1 at one launch a layer, none with q/k/v/out adapters
    (their layers take the discrete path), no other kernel."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_model

    variants = {
        "sa": dict(model={"self_attn_at_last": SA_YAML}),
        "sa cross+strong+differentiable+add_pe": dict(
            model={"self_attn_at_last": SA_FULL}),
        "dbn": dict(model={"add_bn": "dbn"}),
        "vpt_pe": dict(model={"vpt_pe": True}),
        "use_before_projection=False": dict(
            model={"use_before_projection": False}),
        "qkvo": dict(model={"attention_adapter": True}),
        "filip": filip_over(sizes),
    }
    nclass = sizes.head["nclass"]
    centers = torch.randn(nclass, sizes.head.get("center_dim", 512),
                          generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(41)
    raw = torch.randint(0, 256, (sizes.variant_images, sizes.image_side,
                                 sizes.image_side, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    for name, over in variants.items():
        t_var = time.perf_counter()
        cfg = variant_config(sizes, **over)
        model, _ = build_model(cfg, centers, device=device)
        seed_adapters(model, torch.Generator().manual_seed(1))
        model.eval()
        vcfg = model.vision_cfg
        images = normalize(center_crop(raw, vcfg.image_size), 3)
        torch.cuda.synchronize()
        count_reset()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(images)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = counts()
        cpu, _ = build_model(dict(cfg, compute_dtype="float32"), centers,
                             device=torch.device("cpu"))
        cpu.load_state_dict(model.state_dict())
        with torch.inference_mode():
            want = cpu.eval()(images.cpu())
        codes = out["codes"]
        agree = ((codes.cpu() > 0) == (want["codes"] > 0)).float().mean() \
            .item()
        n_lay = 0 if name == "qkvo" else vcfg.num_layers
        expect = (n_lay, 0, 0, 0, 0, 0)
        finite = all(torch.isfinite(v).all() for k, v in out.items()
                     if k.startswith(("codes", "logits")))
        print(f"variant {name}: {sizes.variant_images} images encode in "
              f"{card_s * 1e3:.1f} ms (first call); outputs "
              f"{sorted(k for k in out if k.startswith('logits'))}; sign "
              f"agreement with the CPU's f32 codes {agree:.6f} (max |d| "
              f"{(codes.float().cpu() - want['codes']).abs().max():.4g}); "
              f"launches {launches}, expected {expect}; "
              f"{time.perf_counter() - t_var:.1f} s with the builds and the "
              "CPU encode")
        if (codes.shape != (sizes.variant_images, cfg["model"]["nbit"])
                or not finite):
            fail(f"variant {name}: outputs not finite or codes of shape "
                 f"{tuple(codes.shape)}")
        if agree < MIN_SIGN_AGREEMENT:
            fail(f"variant {name}: codes agree in sign with the CPU's on "
                 f"{agree:.4f} < {MIN_SIGN_AGREEMENT}")
        if launches != expect:
            fail(f"variant {name}: launches {launches} != {expect}")
        del model, cpu, out, want
    torch.cuda.empty_cache()


def variant_steps(sizes: Sizes, device) -> None:
    """Phase 16 (b): five train steps of each variant at the kernel
    settings on one seeded batch (the same dropout masks each step),
    counted per step: kernels 5 and 6 once and twice a layer (q/k/v/out
    adapters: no kernel 6; remat recomputes each layer's forward in the
    backward, so twice that); the loss finite and lower at step 5. Then a
    remat step against a stored-activation step, and graphed chunks against
    eager steps for SA + DBN, FILIP and lars, bit for bit."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_training

    nclass = sizes.head["nclass"]
    centers = torch.randn(nclass, sizes.head.get("center_dim", 512),
                          generator=torch.Generator().manual_seed(0))
    dgen = torch.Generator(device=device).manual_seed(47)
    side = sizes.image_side
    raw = torch.randint(0, 256, (sizes.train_batch, side, side, 3),
                        generator=dgen, device=device, dtype=torch.uint8)
    y = torch.randint(0, nclass, (sizes.train_batch,), generator=dgen,
                      device=device)
    variants = {
        "sa+dbn": dict(model={"self_attn_at_last": SA_YAML,
                              "add_bn": "dbn"}),
        "filip": filip_over(sizes),
        "vpt_pe+remat": dict(model={"vpt_pe": True},
                             backbone={"remat": True}),
        "qkvo": dict(model={"attention_adapter": True}),
    }
    for name, over in variants.items():
        cfg = variant_config(sizes, **over)
        tr = build_training(cfg, centers, sizes.steps_per_epoch,
                            device=device, vision=TRAIN_VISION)
        n_lay = tr.model.vision_cfg.num_layers
        batch = {"image": normalize(center_crop(
            raw, tr.model.vision_cfg.image_size), 3),
            "label": F.one_hot(y, nclass).float()}
        runs = n_lay * (2 if over.get("backbone", {}).get("remat") else 1)
        expect = (0, 0, 0, 0 if name == "qkvo" else 2 * runs, runs, 0)
        torch.cuda.synchronize()
        count_reset()
        losses, per_step = [], []
        for i in range(sizes.train_steps):
            if i == 1:                  # the first step warms up
                t0 = time.perf_counter()
            before = counts()
            tr.generator.manual_seed(1)
            losses.append(float(tr.step(batch)["loss"]))
            per_step.append(tuple(a - b for a, b in zip(counts(), before)))
        step_ms = (time.perf_counter() - t0) / (sizes.train_steps - 1) * 1e3
        print(f"variant {name} train steps (B={sizes.train_batch}, kernels "
              f"5 and 6): loss " + ", ".join(f"{x:.5f}" for x in losses)
              + f"; launches per step {per_step[0]}, expected {expect}, all "
              f"steps alike: {len(set(per_step)) == 1}; {step_ms:.1f} ms a "
              "step after the first (host clock, synchronized by the loss "
              "read, eager)")
        if any(p != expect for p in per_step):
            fail(f"variant {name}: launches per step {per_step} != "
                 f"{expect}")
        if not all(math.isfinite(x) for x in losses) or \
                losses[-1] >= losses[0]:
            fail(f"variant {name}: loss {losses} not finite or not falling")
        del tr

    # ---- a remat step against a stored-activation step ----
    over = variants["vpt_pe+remat"]
    got = []
    for remat in (True, False):
        cfg = variant_config(sizes, model=over["model"],
                             backbone={"remat": remat})
        tr = build_training(cfg, centers, sizes.steps_per_epoch,
                            device=device, vision=TRAIN_VISION)
        batch = {"image": normalize(center_crop(
            raw, tr.model.vision_cfg.image_size), 3),
            "label": F.one_hot(y, nclass).float()}
        tr.generator.manual_seed(1)
        loss = float(tr.step(batch)["loss"])
        got.append((loss, {n: p.detach().clone()
                           for n, p in tr.model.named_parameters()}))
        del tr
    (l1, p1), (l0, p0) = got
    d = max((p1[n].float() - p0[n].float()).abs().max().item() for n in p1)
    same = l1 == l0 and d == 0.0
    print(f"remat step vs stored-activation step (vpt_pe, kernels 5 and 6): "
          f"loss {l1:.6f} vs {l0:.6f}, parameters max |d| {d:.3g}: bit for "
          f"bit {same} (required)")
    if not same:
        fail("a remat step differs from a stored-activation step")
    torch.cuda.empty_cache()

    # ---- graphed chunks against eager steps ----
    checked = check_sizes(sizes)
    graph_vs_eager_train(checked, device, TRAIN_VISION,
                         over=variants["sa+dbn"], label="sa+dbn")
    graph_vs_eager_train(checked, device, TRAIN_VISION,
                         over=variants["filip"], label="filip")
    graph_vs_eager_train(checked, device, TRAIN_VISION, LARS_OPTIM)
    torch.cuda.empty_cache()


def run_variant_runs(sizes: Sizes, device, tmp: str, argv, eval_argv,
                     hf_dir: str, flagship: dict) -> None:
    """Phase 16 (c): ``main_gpu.py model=concepthash_sa`` and
    ``model=concepthash_filip`` on phase 15's synthetic set at
    ``train_chunk`` auto, 2 epochs each, the launch counts from zero
    (kernel 1 at one launch a layer and eval batch, replays included; no
    other kernel); FILIP's class-text token embeddings from phase 15 (d)'s
    local checkpoint, within ``TEXT_ATOL`` of the CPU's; the eval-only
    modes and a resume; train and eval img/s beside phase 15's
    flagship."""
    import os

    import main_gpu
    from concepthash_tpu_torch.data.manifest import read_class_names
    from concepthash_tpu_torch.train.codebook import embed_class_name_tokens

    t_phase = time.perf_counter()
    rows = [("flagship (phase 15)", flagship["train_img_s"],
             flagship["eval_img_s"])]
    for model, extra in (("concepthash_sa", ()),
                         ("concepthash_filip", (f"backbone.name={hf_dir}",))):
        extra = (f"model={model}", *extra)
        run = os.path.join(tmp, model)
        exp = main_gpu.build_experiment(argv(run, *extra))
        secs = time_encodes(exp)
        torch.cuda.synchronize()
        count_reset()
        t0 = time.perf_counter()
        exp.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        with open(os.path.join(run, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(run, "test_history.json")) as f:
            test = json.load(f)
        with open(os.path.join(run, "log.txt")) as f:
            log = f.read()
        steps = len(exp.loaders["train"])
        batch = int(exp.config["batch_size"])
        K = exp.train_chunk
        n_layers = exp.model.vision_cfg.num_layers
        eval_batches = len(exp.loaders["test"]) + len(exp.loaders["db"])
        want = (2 * n_layers * eval_batches, 0, 0, 0, 0, 0)
        runner = exp.train_multi_step
        print(f"{model} run (train_chunk {K}): {steps} steps of {batch} an "
              f"epoch; train records "
              + "; ".join(f"ep {r['ep']} loss {r['loss']:.5f} "
                          f"{r['time']:.2f} s" for r in train)
              + "; test mAP " + ", ".join(f"{r['mAP']:.6f}" for r in test)
              + f"; graph replays {getattr(runner, 'replays', 0)} train; "
              f"launches {launches}, expected {want}; the run {run_s:.1f} s")
        if len(train) != 2 or len(test) != 2 or not all(
                math.isfinite(r["loss"]) for r in train):
            fail(f"{model}: not two finite train records and two test "
                 "records")
        if launches != want:
            fail(f"{model}: kernel 1 not launched once a layer and eval "
                 "batch, or another kernel launched")
        if device.type == "cuda" and runner.replays != 2 * (steps // K) - 1:
            fail(f"{model}: {runner.replays} train replays, expected "
                 f"{2 * (steps // K) - 1}")
        if model == "concepthash_sa":
            if exp.model.self_attn_at_last is None:
                fail("concepthash_sa built without SelfAttentionAtLast")
        else:
            names = read_class_names(os.path.join(tmp, "synth"))
            cpu = embed_class_name_tokens(names, hf_dir, device="cpu")
            got = exp.config["model"]["token_embeds_array"]
            err = float(np.abs(got - cpu).max())
            buf = exp.model.token_embeds
            print(f"{model}: class-text token embeddings {got.shape} from "
                  f"the local checkpoint's text stage on {device.type}, max "
                  f"|d| against the CPU's {err:.3g} (tolerance {TEXT_ATOL}); "
                  f"the model's buffer equal: "
                  f"{torch.equal(buf.cpu(), torch.as_tensor(got))}")
            if "pseudo-tokens" in log or err > TEXT_ATOL or \
                    not torch.equal(buf.cpu(), torch.as_tensor(got)):
                fail(f"{model}: the token embeddings did not come from the "
                     f"local text stage, or differ from the CPU's by {err}")
        rows.append((model, steps * batch / train[1]["time"],
                     eval_img_s(exp, secs)[1]))
        for loader in exp.loaders.values():
            loader.close()
        del exp
        eval_only_modes(model, run, test, eval_argv)
        check_resume(model, tmp, run, train, argv, *extra)
    print("phase 16 (c) img/s, epoch-2 train and eval encode, train_chunk "
          "auto: " + "; ".join(f"{n} train {t:.1f}, eval {e:.1f}"
                               for n, t, e in rows)
          + f"; {card_line() if device.type == 'cuda' else 'the CPU'}")
    print(f"phase 16 (c): {time.perf_counter() - t_phase:.1f} s")


def run_variants(sizes: Sizes, device) -> None:
    """Phase 16 (a) and (b)."""
    t0 = time.perf_counter()
    variant_forwards(sizes, device)
    variant_steps(sizes, device)
    print(f"phase 16 (a), (b): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the supervised baselines on the CLIP-adapter trunk
# ---------------------------------------------------------------------------

# each method's configs/model/*.yaml (descriptor has none: ce_adapter's
# groups with no objective)
BASELINE_YAML = {
    "orthohash": "orthohash_adapter", "orthohash_bcs": "orthohash_bcs_adapter",
    "csq": "csq_adapter", "dpn": "dpn_adapter", "hashnet": "hashnet_adapter",
    "dpsh": "dpsh_adapter", "dtsh": "dtsh_adapter",
    "greedyhash": "sgh_adapter", "ce": "ce_adapter",
    "descriptor": "ce_adapter", "clip": "clip_finetune",
}
# bf16 card logits against the CPU's f32: max |d| <= LOGIT_RTOL * max |ref|
LOGIT_RTOL = 0.05
# descriptor's and clip's features: mean row cosine against the CPU's
MIN_FEATURE_COSINE = 0.99


def baseline_config(sizes: Sizes, name: str) -> dict:
    """The config dicts of the method's configs/model/*.yaml (with
    dataset=cub200) at ``sizes``' model: its backbone, nbit and nclass, in
    bf16."""
    import os

    from concepthash_tpu_torch.config.loader import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    yaml = {**BASELINE_YAML, **FINEGRAINED_YAML, **UNSUP_YAML,
            **PRETRAIN_YAML}[name]
    cfg = load_config(os.path.join(root, "configs"), "train",
                      ["dataset=cub200", f"model={yaml}",
                       "compute_dtype=bfloat16"])
    cfg["model"].update(name=name, nclass=sizes.head["nclass"],
                        nbit=sizes.head["nbit"])
    if name in ("descriptor", "unsup_greedyhash"):
        cfg["criterion"] = {}
    cfg["backbone"] = ({"name": "cut", **sizes.vision} if sizes.vision
                       else {"name": "openai/clip-vit-base-patch32"})
    cfg["seed"] = 0
    return cfg


def baseline_codebook(sizes: Sizes, name: str, cfg: dict):
    """The method's codebook from its config (orthohash's N, csq's H,
    dpn's B, signed), clip's seeded (nclass, proj) class-text centers, or
    None."""
    from concepthash_tpu_torch.methods import get_method, prepare_codebook

    if name == "clip":
        proj = sizes.vision.get("projection_dim", 512)
        return torch.randn(sizes.head["nclass"], proj, generator=torch
                           .Generator().manual_seed(0)).numpy()
    return prepare_codebook(get_method(name), cfg)


def row_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean cosine of the rows of ``a`` and ``b`` (float32, on the CPU)."""
    from concepthash_tpu_torch.ops.numerics import l2_normalize

    return (l2_normalize(a.float().cpu()) * l2_normalize(b.float().cpu())) \
        .sum(-1).mean().item()


def with_trunk(model, trunk):
    """``model`` (built with a 0-layer tower) on the shared ``trunk``."""
    model.backbone = trunk
    model.vision_cfg = trunk.tower.cfg
    return model


def baseline_on(sizes: Sizes, name: str, trunk, device, vision=None):
    """(config, codebook, model, loss) of ``name``: the head built from the
    config's seed, on ``trunk``."""
    from concepthash_tpu_torch.methods import build_model

    cfg = baseline_config(sizes, name)
    cb = baseline_codebook(sizes, name, cfg)
    model, loss_fn = build_model(cfg, cb, device=device,
                                 vision=dict(num_layers=0, **(vision or {})))
    return cfg, cb, with_trunk(model, trunk), loss_fn


def seeded_trunk(sizes: Sizes, device, vision=None, like=None,
                 adapters: bool = True):
    """The baselines' shared trunk: ViT-B/32 with adapters at
    ``sizes.bottleneck`` (none without ``adapters``), bf16, seeded weights
    (the adapters' up-projections too); ``like`` copies another trunk's
    weights."""
    from concepthash_tpu_torch.models.backbone_factory import \
        vision_config_from_backbone_cfg
    from concepthash_tpu_torch.models.clip import AdapterConfig
    from concepthash_tpu_torch.models.trunk import clip_trunk

    vcfg = vision_config_from_backbone_cfg(
        baseline_config(sizes, "orthohash")["backbone"])
    if vision:
        vcfg = dataclasses.replace(vcfg, **vision)
    gen = torch.Generator().manual_seed(5)
    # bf16 on the card, as the configs run; the CPU's reference in f32
    trunk = clip_trunk(vcfg,
                       AdapterConfig(bottleneck_dim=sizes.bottleneck)
                       if adapters else None,
                       torch.bfloat16 if device.type == "cuda"
                       else torch.float32, gen)
    seed_adapters(trunk, gen)
    if like is not None:
        trunk.load_state_dict(like.state_dict())
    return trunk.to(device)


def baseline_forwards(sizes: Sizes, device) -> None:
    """Phase 17 (a): every method's head on the one shared trunk encodes
    ``sizes.variant_images`` seeded images in bf16 on the card, counted
    (kernel 1 once a layer, no other kernel), against the same weights at
    float32 on the CPU, whose trunk runs once: codes agree in sign on
    >= 99% of bits (descriptor's and clip's features: mean row cosine >=
    0.99), and orthohash's, ce's and clip's logits within LOGIT_RTOL."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_model

    t_a = time.perf_counter()
    trunk = seeded_trunk(sizes, device)
    vcfg = trunk.tower.cfg
    gen = torch.Generator(device=device).manual_seed(53)
    raw = torch.randint(0, 256, (sizes.variant_images, sizes.image_side,
                                 sizes.image_side, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    images = normalize(center_crop(raw, vcfg.image_size), 3)
    cpu_trunk = seeded_trunk(sizes, torch.device("cpu"), like=trunk)
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc_cpu = cpu_trunk(images.float().cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_trunk
    n_lay = vcfg.num_layers
    rows = []
    for name in BASELINE_YAML:
        cfg, cb, model, _ = baseline_on(sizes, name, trunk, device)
        model.eval()
        torch.cuda.synchronize()
        count_reset()
        with torch.inference_mode():
            out = model(images)
        torch.cuda.synchronize()
        launches = counts()
        cpu, _ = build_model(dict(cfg, compute_dtype="float32"), cb,
                             device=torch.device("cpu"),
                             vision=dict(num_layers=0))
        head = {k: v for k, v in model.state_dict().items()
                if not k.startswith("backbone.")}
        cpu.load_state_dict(head, strict=False)
        with torch.inference_mode():
            want = cpu.eval().head(enc_cpu)
        codes, ref = out["codes"].float().cpu(), want["codes"]
        if name in ("descriptor", "clip"):
            agree = row_cosine(codes, ref)
            limit, what = MIN_FEATURE_COSINE, "feature cosine"
        else:
            agree = ((codes > 0) == (ref > 0)).float().mean().item()
            limit, what = MIN_SIGN_AGREEMENT, "sign agreement"
        logit_err = {k: ((out[k].float().cpu() - want[k]).abs().max()
                         / want[k].abs().max()).item()
                     for k in ("logits", "logits2") if k in want
                     and name in ("orthohash", "orthohash_bcs", "ce",
                                  "clip")}
        expect = (n_lay, 0, 0, 0, 0, 0)
        finite = all(torch.isfinite(v).all() for v in out.values())
        rows.append(f"{name} {what} {agree:.6f}" + "".join(
            f", {k} rel |d| {v:.3g}" for k, v in logit_err.items()))
        print(f"baseline {name} encode ({sizes.variant_images} images, "
              f"bf16 on the card against f32 on the CPU): codes "
              f"{tuple(codes.shape)}, {what} {agree:.6f} (limit {limit}); "
              + "".join(f"{k} max |d| / max |ref| {v:.4g} (limit "
                        f"{LOGIT_RTOL}); " for k, v in logit_err.items())
              + f"launches {launches} against {expect}")
        if not finite or codes.shape[0] != sizes.variant_images:
            fail(f"baseline {name}: outputs not finite")
        if agree < limit:
            fail(f"baseline {name}: {what} {agree:.4f} < {limit}")
        if any(v > LOGIT_RTOL for v in logit_err.values()):
            fail(f"baseline {name}: logits {logit_err} beyond {LOGIT_RTOL}")
        if launches != expect:
            fail(f"baseline {name}: launches {launches} != {expect}")
        del model, cpu, out, want
    print(f"phase 17 (a): {time.perf_counter() - t_a:.1f} s (the CPU's f32 "
          f"trunk once: {cpu_s:.1f} s)")
    del trunk
    torch.cuda.empty_cache()


def baseline_steps(sizes: Sizes, device) -> None:
    """Phase 17 (b): five eager train steps of every method at B=32 at the
    kernel settings on one seeded batch, counted per step (kernels 5 and 6
    once and twice a layer); the loss finite and falling; the frozen
    backbone bit-unchanged; descriptor's loss zero and, at weight decay 0,
    its adapters unchanged (the config's adam would move them by its
    weight decay alone, as in the reference); hashnet with
    ``keep_train_size``: each step's bank rows equal to its batch's
    detached tanh(beta * codes) and labels after every step (the batch at
    dataset rows 0..B-1 of 2B, the other rows untouched). Then, for every
    method but
    hashnet (one step a dispatch), a graphed chunk against eager steps:
    a warm-up chunk and a replay, losses, parameters and BatchNorm
    statistics bit for bit."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import training_for
    from concepthash_tpu_torch.train.custom_steps import hashnet_beta

    t_b = time.perf_counter()
    trunk = seeded_trunk(sizes, device, TRAIN_VISION)
    vcfg = trunk.tower.cfg
    n_lay = vcfg.num_layers
    nclass = sizes.head["nclass"]
    B, steps = sizes.train_batch, sizes.train_steps
    dgen = torch.Generator(device=device).manual_seed(59)
    raw = torch.randint(0, 256, (B, sizes.image_side, sizes.image_side, 3),
                        generator=dgen, device=device, dtype=torch.uint8)
    y = torch.randint(0, nclass, (B,), generator=dgen, device=device)
    batch = {"image": normalize(center_crop(raw, vcfg.image_size), 3),
             "label": F.one_hot(y, nclass).float()}
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()}
    expect = (0, 0, 0, 2 * n_lay, n_lay, 0)
    for name in BASELINE_YAML:
        t_m = time.perf_counter()
        cfg, cb, model, loss_fn = baseline_on(
            sizes, name, copy.deepcopy(trunk), device, TRAIN_VISION)
        if name == "hashnet":
            # the batch's images are dataset rows 0..B-1 of a set of 2B
            cfg["criterion"]["keep_train_size"] = 1
            cfg["_train_size_"] = 2 * B
            beta = hashnet_beta(0, sizes.steps_per_epoch,
                                int(cfg["criterion"]["step_continuation"]))
        if name == "descriptor":
            cfg["optim"]["weight_decay"] = 0.0
        tr = training_for(cfg, model, loss_fn, sizes.steps_per_epoch)
        codes_seen = []
        hook = model.register_forward_hook(
            lambda m, i, o: codes_seen.append(o["codes"].detach()))
        torch.cuda.synchronize()
        count_reset()
        losses, per_step, bank_ok = [], [], True
        for i in range(steps):
            if i == 1:
                t0 = time.perf_counter()
            before = counts()
            b = dict(batch)
            if name == "hashnet":
                b["index"] = torch.arange(B, device=device)
            losses.append(float(tr.step(b)["loss"]))
            per_step.append(tuple(a - c for a, c in zip(counts(), before)))
            if name == "hashnet":
                bank_ok &= (torch.equal(tr.extra["U"][:B],
                                        torch.tanh(beta * codes_seen[-1]))
                            and torch.equal(tr.extra["Y"][:B],
                                            batch["label"])
                            and not tr.extra["U"][B:].any())
        step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
        hook.remove()
        sd = model.backbone.state_dict()
        moved_frozen = [k for k, v in frozen.items()
                        if "adapter" not in k and not torch.equal(sd[k], v)]
        adapters_same = all(torch.equal(sd[k], v) for k, v in frozen.items()
                            if "adapter" in k)
        extra = ""
        if name == "hashnet":
            extra = (f"; the bank's rows equal each batch's detached "
                     f"tanh(beta * codes) and labels: {bank_ok} (beta "
                     f"{beta})")
        print(f"baseline {name} train steps (B={B}, kernels 5 and 6): loss "
              + ", ".join(f"{x:.5f}" for x in losses)
              + f"; launches per step {per_step[0]} against {expect}, the "
              f"same every step: {len(set(per_step)) == 1}; frozen backbone "
              f"unchanged: {not moved_frozen}; adapters unchanged: "
              f"{adapters_same}{extra}; {step_ms:.1f} ms a step after the "
              "first (host clock, eager)")
        if any(p != expect for p in per_step):
            fail(f"baseline {name}: launches per step {per_step}")
        if moved_frozen:
            fail(f"baseline {name}: frozen parameters moved: "
                 f"{moved_frozen[:3]}")
        if name == "descriptor":
            if any(x != 0.0 for x in losses) or not adapters_same:
                fail("descriptor: loss not zero or adapters moved")
        elif not all(math.isfinite(x) for x in losses) or \
                losses[-1] >= losses[0] or adapters_same:
            fail(f"baseline {name}: loss {losses} not finite or not "
                 "falling, or the adapters did not move")
        if name == "hashnet" and not bank_ok:
            fail("hashnet: the bank's rows differ from their batches'")
        del tr, model
        if name != "hashnet":
            baseline_graph_vs_eager(sizes, name, trunk, device)
        print(f"baseline {name}: {time.perf_counter() - t_m:.1f} s")
    print(f"phase 17 (b): {time.perf_counter() - t_b:.1f} s")
    del trunk
    torch.cuda.empty_cache()


def baseline_graph_vs_eager(sizes: Sizes, name: str, trunk, device,
                            label: str = "baseline", views: int = 1,
                            aux: bool = False) -> None:
    """Two chunks of ``sizes.check_chunk`` steps through
    ``make_multi_train_step`` (a warm-up, then a replay) against as many
    eager steps from the same state, bit for bit; ``views`` and ``aux`` as
    ``stacked_batches`` takes them (a two-view method's batches, SSDH's
    staged structure blocks)."""
    from concepthash_tpu_torch.methods import training_for
    from concepthash_tpu_torch.train.state import make_multi_train_step

    sizes = check_sizes(sizes)
    trs = []
    for _ in range(2):
        cfg, cb, model, loss_fn = baseline_on(
            sizes, name, copy.deepcopy(trunk), device, TRAIN_VISION)
        trs.append(training_for(cfg, model, loss_fn, sizes.steps_per_epoch))
    graph, eager = trs
    nclass = sizes.head["nclass"]
    batches, stacked = stacked_batches(sizes, trunk.tower.cfg, nclass, 2,
                                       device, 61, views=views, aux=aux)
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    g_loss = [x for chunk in stacked for x in multi(chunk)["loss"].tolist()]
    e_loss = [float(eager.step(b)["loss"]) for b in batches]
    gs, es = graph.model.state_dict(), eager.model.state_dict()
    d = max((gs[k].float() - es[k].float()).abs().max().item() for k in gs)
    same = g_loss == e_loss and d == 0.0
    K, n_lay = sizes.graph_chunk, trunk.tower.cfg.num_layers
    want = {"ln_matmul_cuda": 2 * K * n_lay, "attention_cuda": K * n_lay}
    per_replay = getattr(multi, "launches_per_replay", want)
    staged = {k: tuple(v.shape) for k, v in stacked[0].items()}
    print(f"{label} {name} graph vs eager train (K={K}, a warm-up chunk "
          f"and a replay, staged {staged}): losses {g_loss[-1]:.5f} / "
          f"{e_loss[-1]:.5f} at the last step, state max |d| {d:.3g}: bit "
          f"for bit {same} (required); replays {getattr(multi, 'replays', 0)}"
          f", launches per replay {per_replay}")
    if not same:
        fail(f"{label} {name}: graphed steps differ from eager ones")
    if per_replay != want:
        fail(f"{label} {name}: launches per replay {per_replay} != {want}")
    del graph, eager, trs


def run_baselines(sizes: Sizes, device) -> None:
    """Phase 17 (a) and (b)."""
    t0 = time.perf_counter()
    baseline_forwards(sizes, device)
    baseline_steps(sizes, device)
    print(f"phase 17 (a), (b): {time.perf_counter() - t0:.1f} s")


def run_model_runs(label: str, device, tmp: str, argv, eval_argv,
                   flagship: dict, runs) -> None:
    """Phases 17 (c) to 20 (c): ``main_gpu.py model=<config>`` for each of
    ``runs`` on phase 15's synthetic set at ``train_chunk`` auto, 2 epochs
    each, counted (kernel 1 at one launch a layer and eval batch, the adsh
    regime's subset encodes, SSDH's structure encode and ODC's k-means
    encode included; no other kernel): finite records and
    the graph replays (none where ``single``: a method's own step and the
    adsh regime run one step a dispatch, and the log says so). Then, in
    the sgd regime, ``exp=validation use_last=true`` within 1e-6 of the
    run's last mAP, at ``configs/val.yaml``'s batch size or, where
    ``val_at_run_batch`` (SEMICON's batch-global mask, a CNN's cuDNN
    convolutions), at the run's; in
    the adsh regime a +-1 (n_train, nbit) ``outputs/db_codes.pt`` and a mAP
    in [0, 1]. ``check(exp)``: a model's own checks. Epoch-2 train and eval
    img/s (the adsh regime: its whole run's) beside phase 15's flagship.

    ``runs``: (model, options), options among ``extra`` (overrides),
    ``single``, ``val_at_run_batch``, ``check``, ``name`` (the run
    directory's, the model's by default) and ``resume`` (a run stopped
    after epoch 1 and resumed, held by ``check_resume``)."""
    import os

    import main_gpu

    t_c = time.perf_counter()
    rows = [("flagship (phase 15)", flagship["train_img_s"],
             flagship["eval_img_s"])]
    for model, opt in runs:
        run = os.path.join(tmp, opt.get("name", model))
        exp = main_gpu.build_experiment(argv(run, f"model={model}",
                                             *opt.get("extra", ())))
        secs = time_encodes(exp)
        torch.cuda.synchronize()
        count_reset()
        t0 = time.perf_counter()
        exp.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        with open(os.path.join(run, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(run, "test_history.json")) as f:
            test = json.load(f)
        with open(os.path.join(run, "log.txt")) as f:
            log = f.read()
        adsh = exp.method.regime == "adsh"
        single = opt.get("single", False)
        steps = exp.steps_per_epoch
        batch = int(exp.config["batch_size"])
        K = exp.train_chunk
        vcfg = exp.model.vision_cfg     # None: a trunk without kernel 1
        n_layers = vcfg.num_layers if vcfg is not None else 0
        if adsh:    # the subset's encode each epoch, then the test split
            per_epoch = -(-exp.adsh_settings["num_samples"] // batch)
            eval_batches = exp.epochs * per_epoch + len(exp.loaders["test"])
        else:
            eval_batches = 2 * (len(exp.loaders["test"])
                                + len(exp.loaders["db"]))
        if exp.method.needs_structure or exp.method.regime == "odc":
            # SSDH's structure and ODC's k-means: the train split's encode
            eval_batches += -(-len(exp.datasets["train"]) // batch)
        want = (n_layers * eval_batches, 0, 0, 0, 0, 0)
        runner = exp.train_multi_step
        replays = getattr(runner, "replays", 0)
        want_replays = (0 if single or device.type != "cuda"
                        else 2 * (steps // K) - 1)
        print(f"{model} run (train_chunk {K}): {steps} steps of {batch} an "
              "epoch; train records "
              + "; ".join(f"ep {r['ep']} loss {r['loss']:.5f}"
                          + (f" {r['time']:.2f} s" if "time" in r else "")
                          for r in train)
              + "; test mAP " + ", ".join(f"{r['mAP']:.6f}" for r in test)
              + f"; graph replays {replays} train (expected "
              f"{want_replays}); launches {launches} against {want}; the "
              f"run {run_s:.1f} s")
        if len(train) != 2 or len(test) != (1 if adsh else 2) or not all(
                math.isfinite(r["loss"]) for r in train):
            fail(f"{model}: not two finite train records and the test "
                 "records")
        if launches != want:
            fail(f"{model}: kernel 1 not launched once a layer and eval "
                 "batch, or another kernel launched")
        if replays != want_replays or (single and runner is not None):
            fail(f"{model}: {replays} train replays, expected "
                 f"{want_replays}")
        if single and K > 1 and "does not apply" not in log:
            fail(f"{model}: the log does not say train_chunk does not apply")
        if "check" in opt:
            opt["check"](exp)
        if adsh:    # one test encode at the end: time a warm one
            eval_rate = len(exp.datasets["test"]) / run_eval_s(exp)
        else:
            eval_rate = eval_img_s(exp, secs)[1]
        if adsh:
            V = torch.load(os.path.join(run, "outputs", "db_codes.pt"))["V"]
            shape = (len(exp.datasets["train"]),
                     int(exp.config["model"]["nbit"]))
            print(f"{model}: outputs/db_codes.pt {tuple(V.shape)}, values "
                  f"{sorted(V.unique().tolist())}; mAP {test[0]['mAP']:.6f}"
                  f" scored with V as the database")
            if tuple(V.shape) != shape or set(V.unique().tolist()) != {
                    -1.0, 1.0} or not 0.0 <= test[0]["mAP"] <= 1.0:
                fail(f"{model}: db_codes.pt or its mAP is wrong")
            # whole-run rate: SGD steps with the subset encodes and DCC
            rows.append((f"{model} (adsh, whole run)",
                         exp.epochs * steps * batch / run_s, eval_rate))
        else:
            rows.append((model, steps * batch / train[1]["time"],
                         eval_rate))
        for loader in exp.loaders.values():
            loader.close()
        del exp
        if adsh:
            continue
        over = (f"batch_size={batch}",) if opt.get("val_at_run_batch") \
            else ()
        ev = main_gpu.build_experiment(eval_argv(
            "exp=validation", f"logdir={run}", "use_last=true", *over))
        got = ev.main()
        d_map = abs(got["mAP"] - test[-1]["mAP"])
        print(f"{model} exp=validation use_last=true"
              + (f" batch_size={batch}" if over else "") + f": mAP "
              f"{got['mAP']:.6f} against the run's last "
              f"{test[-1]['mAP']:.6f}, |d| {d_map:.3g} (tolerance "
              f"{REPLAY_MAP_ATOL})")
        if d_map > REPLAY_MAP_ATOL:
            fail(f"{model}: exp=validation does not reproduce the run")
        del ev
        if opt.get("resume"):
            check_resume(opt.get("name", model), tmp, run, train, argv,
                         f"model={model}", *opt.get("extra", ()))
    print(f"{label} img/s, epoch-2 train and eval encode, train_chunk auto: "
          + "; ".join(f"{n} train {t:.1f}, eval {e:.1f}" for n, t, e in rows)
          + f"; {card_line() if device.type == 'cuda' else 'the CPU'}")
    print(f"{label}: {time.perf_counter() - t_c:.1f} s")


def run_baseline_runs(device, tmp: str, argv, eval_argv, hf_dir: str,
                      flagship: dict) -> None:
    """Phase 17 (c): ``model=orthohash_adapter``, ``model=hashnet_adapter``
    (one step a dispatch) and ``model=clip_finetune`` (its vision tower and
    class-text centers from phase 15 (d)'s local checkpoint, the centers
    from its text stage on the card within ``TEXT_ATOL`` of the CPU's)
    through ``run_model_runs``."""
    import os

    from concepthash_tpu_torch.methods import prepare_codebook

    def text_centers(exp):
        cpu = prepare_codebook(exp.method, exp.config,
                               device=torch.device("cpu"))
        err = float(np.abs(exp.codebook - cpu).max())
        same = torch.equal(exp.model.text_centers.cpu(),
                           torch.as_tensor(exp.codebook))
        with open(os.path.join(exp.logdir, "log.txt")) as f:
            log = f.read()
        print(f"clip_finetune: class-text centers {exp.codebook.shape} from "
              f"the local checkpoint's text stage on {device.type}, max |d| "
              f"against the CPU's {err:.3g} (tolerance {TEXT_ATOL}); the "
              f"model's centers equal: {same}; logit_scale "
              f"{exp.model.logit_scale.item():.6f}")
        if "fallback" in log or "falls back" in log or \
                "pretrained weights unavailable" in log or \
                err > TEXT_ATOL or not same:
            fail(f"clip_finetune: the centers did not come from the local "
                 f"text stage, or differ from the CPU's by {err}")

    run_model_runs("phase 17 (c)", device, tmp, argv, eval_argv, flagship, (
        ("orthohash_adapter", {}),
        ("hashnet_adapter", {"single": True}),
        ("clip_finetune", {"extra": (f"backbone.name={hf_dir}",),
                           "check": text_centers})))


# ---------------------------------------------------------------------------
# phase 18: the fine-grained heads, the adsh regime, the autoencoder
# binarizers, and the loader's native decode and image cache
# ---------------------------------------------------------------------------

FINEGRAINED_YAML = {"a2net_ce": "a2net_ce_adapter",
                    "semicon_ce": "semicon_ce_adapter", "semicon": "semicon",
                    "adsh": "adsh"}
# the database codes of solve_dcc on the card against the CPU's: least share
# of equal entries (a sign whose argument is within rounding of 0 may flip)
MIN_DCC_AGREEMENT = 0.999
# configs/model/semicon.yaml's and adsh.yaml's criterion gamma
ADSH_GAMMA = 200.0


class GivenTrunk(torch.nn.Module):
    """A trunk that returns outputs computed before: the CPU's f32 trunk,
    run once for every head."""

    def __init__(self, enc: dict):
        super().__init__()
        self.enc = enc

    def forward(self, images, train: bool = False,
                output_attentions: bool = False, generator=None) -> dict:
        return self.enc


def finegrained_forwards(sizes: Sizes, device) -> None:
    """Phase 18 (a): the four models' heads (A2NetCE, SemiconCE, Semicon,
    adsh's csq head) on one seeded trunk encode ``sizes.variant_images``
    seeded images in bf16 on the card, counted (kernel 1 once a layer, no
    other kernel), against the same weights at float32 on the CPU, whose
    trunk runs once: codes agree in sign on >= 99% of bits, A2NetCE's and
    SemiconCE's logits within LOGIT_RTOL of the largest."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_model

    t_a = time.perf_counter()
    trunk = seeded_trunk(sizes, device)
    vcfg = trunk.tower.cfg
    gen = torch.Generator(device=device).manual_seed(67)
    raw = torch.randint(0, 256, (sizes.variant_images, sizes.image_side,
                                 sizes.image_side, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    images = normalize(center_crop(raw, vcfg.image_size), 3)
    cpu_trunk = seeded_trunk(sizes, torch.device("cpu"), like=trunk)
    with torch.inference_mode():
        enc_cpu = cpu_trunk(images.float().cpu())
    del cpu_trunk
    expect = (vcfg.num_layers, 0, 0, 0, 0, 0)
    for name in FINEGRAINED_YAML:
        cfg, cb, model, _ = baseline_on(sizes, name, trunk, device)
        model.eval()
        torch.cuda.synchronize()
        count_reset()
        with torch.inference_mode():
            out = model(images)
        torch.cuda.synchronize()
        launches = counts()
        cpu, _ = build_model(dict(cfg, compute_dtype="float32"), cb,
                             device=torch.device("cpu"),
                             vision=dict(num_layers=0))
        cpu.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("backbone.")}, strict=False)
        cpu.backbone = GivenTrunk(enc_cpu)
        with torch.inference_mode():
            want = cpu.eval()(images.float().cpu())
        codes, ref = out["codes"].float().cpu(), want["codes"]
        agree = ((codes > 0) == (ref > 0)).float().mean().item()
        logit_err = ({"logits": ((out["logits"].float().cpu()
                                  - want["logits"]).abs().max()
                                 / want["logits"].abs().max()).item()}
                     if "logits" in want else {})
        finite = all(torch.isfinite(v).all() for v in out.values())
        print(f"fine-grained {name} encode ({sizes.variant_images} images, "
              f"bf16 on the card against f32 on the CPU): codes "
              f"{tuple(codes.shape)}, sign agreement {agree:.6f} (limit "
              f"{MIN_SIGN_AGREEMENT}); "
              + "".join(f"{k} max |d| / max |ref| {v:.4g} (limit "
                        f"{LOGIT_RTOL}); " for k, v in logit_err.items())
              + f"launches {launches} against {expect}")
        if not finite or codes.shape != (sizes.variant_images,
                                         sizes.head["nbit"]):
            fail(f"fine-grained {name}: outputs not finite or of a wrong "
                 "shape")
        if agree < MIN_SIGN_AGREEMENT:
            fail(f"fine-grained {name}: sign agreement {agree:.4f}")
        if any(v > LOGIT_RTOL for v in logit_err.values()):
            fail(f"fine-grained {name}: logits {logit_err} beyond "
                 f"{LOGIT_RTOL}")
        if launches != expect:
            fail(f"fine-grained {name}: launches {launches} != {expect}")
        del model, cpu, out, want
    print(f"phase 18 (a): {time.perf_counter() - t_a:.1f} s")
    del trunk
    torch.cuda.empty_cache()


def adsh_batch_targets(sizes: Sizes, labels: torch.Tensor, device) -> dict:
    """The adsh loss's targets for a batch that is ``sizes.adsh_db``-row
    train set's rows 0..B-1: seeded +-1 database codes V, the other rows'
    labels seeded, S their softened similarity to the batch."""
    from concepthash_tpu_torch.losses.baselines import soften_sim

    N, nbit, B = sizes.adsh_db, sizes.head["nbit"], labels.shape[0]
    g = torch.Generator(device=device).manual_seed(73)
    V = torch.randint(0, 2, (N, nbit), generator=g, device=device) * 2.0 - 1
    db = torch.randint(0, sizes.head["nclass"], (N,), generator=g,
                       device=device)
    db[:B] = labels
    S = soften_sim((labels[:, None] == db[None, :]).float() * 2 - 1)
    return {"S": S, "V": V, "V_omega": V[:B]}


def finegrained_steps(sizes: Sizes, device) -> None:
    """Phase 18 (b): five eager train steps each of a2net_ce, semicon_ce
    and adsh (the csq head against ``sizes.adsh_db`` stored codes) at B=32
    at the kernel settings on one seeded batch, counted per step (kernels 5
    and 6 once and twice a layer); the loss finite and, for semicon_ce and
    adsh, falling (a2net_ce's reconstruction term grows on a random
    12-layer tower in the reference too; its train loss and gradients with
    the kernels against their plain versions' stand for it: loss within
    ``TRAIN_LOSS_RTOL``, gradient cosine >= ``MIN_UPDATE_COSINE``); the
    frozen backbone bit-unchanged. Then a graphed chunk of a2net_ce and of
    semicon_ce against eager steps, bit for bit; ``solve_dcc`` at CUB-200's
    size on the card against the CPU; ``ae_fit`` on the card against the
    CPU, then the full fit timed."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.losses.baselines import adsh_loss
    from concepthash_tpu_torch.methods import training_for

    t_b = time.perf_counter()
    trunk = seeded_trunk(sizes, device, TRAIN_VISION)
    vcfg = trunk.tower.cfg
    n_lay = vcfg.num_layers
    nclass, nbit = sizes.head["nclass"], sizes.head["nbit"]
    B, steps = sizes.train_batch, sizes.train_steps
    dgen = torch.Generator(device=device).manual_seed(71)
    raw = torch.randint(0, 256, (B, sizes.image_side, sizes.image_side, 3),
                        generator=dgen, device=device, dtype=torch.uint8)
    y = torch.randint(0, nclass, (B,), generator=dgen, device=device)
    batch = {"image": normalize(center_crop(raw, vcfg.image_size), 3),
             "label": F.one_hot(y, nclass).float()}
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if "adapter" not in k}
    expect = (0, 0, 0, 2 * n_lay, n_lay, 0)
    for name in ("a2net_ce", "semicon_ce", "adsh"):
        t_m = time.perf_counter()
        cfg, cb, model, loss_fn = baseline_on(
            sizes, name, copy.deepcopy(trunk), device, TRAIN_VISION)
        b = dict(batch)
        if name == "adsh":
            b["adsh"] = adsh_batch_targets(sizes, y, device)

            def loss_fn(outputs, bt):
                return adsh_loss(outputs, bt["adsh"], gamma=ADSH_GAMMA,
                                 nbit=nbit)
        tr = training_for(cfg, model, loss_fn, sizes.steps_per_epoch)
        if name == "a2net_ce":
            loss_k, loss_p, cos = grads_vs_plain(model, loss_fn, b)
            worst = min(cos, key=cos.get)
            print(f"fine-grained {name} train forward and backward, kernels "
                  f"vs plain: loss {loss_k:.6f} vs {loss_p:.6f}; gradient "
                  f"cosine min {cos[worst]:.6f} ({worst}), mean "
                  f"{sum(cos.values()) / len(cos):.6f}")
            if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p) or \
                    cos[worst] < MIN_UPDATE_COSINE:
                fail(f"fine-grained {name}: the kernels' gradients differ "
                     "from their plain versions'")
        torch.cuda.synchronize()
        count_reset()
        losses, per_step, parts = [], [], []
        for i in range(steps):
            if i == 1:
                t0 = time.perf_counter()
            before = counts()
            m = tr.step(b)
            losses.append(float(m["loss"]))
            parts.append({k: float(v) for k, v in m.items()
                          if k not in ("loss", "acc")})
            per_step.append(tuple(a - c for a, c in zip(counts(), before)))
        step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
        sd = model.backbone.state_dict()
        moved_frozen = [k for k, v in frozen.items()
                        if not torch.equal(sd[k], v)]
        print(f"fine-grained {name} train steps (B={B}, kernels 5 and 6): "
              "loss " + ", ".join(f"{x:.5f}" for x in losses) + " ("
              + ", ".join(f"{k} {parts[0][k]:.4g} -> {parts[-1][k]:.4g}"
                          for k in parts[0])
              + f"); launches per step {per_step[0]} against {expect}, the "
              f"same every step: {len(set(per_step)) == 1}; frozen backbone "
              f"unchanged: {not moved_frozen}; {step_ms:.1f} ms a step "
              "after the first (host clock, eager)")
        if any(p != expect for p in per_step):
            fail(f"fine-grained {name}: launches per step {per_step}")
        if moved_frozen:
            fail(f"fine-grained {name}: frozen parameters moved: "
                 f"{moved_frozen[:3]}")
        # A2-Net-CE's reconstruction of the 12-layer random tower's
        # features through the tied hash layer grows under the config's
        # adam in the reference too: the gradients against the plain
        # versions' above stand for it
        falls = name == "a2net_ce" or losses[-1] < losses[0]
        if not all(math.isfinite(x) for x in losses) or not falls:
            fail(f"fine-grained {name}: loss {losses} not finite or not "
                 "falling")
        del tr, model
        if name != "adsh":      # one step a dispatch in the adsh regime
            baseline_graph_vs_eager(sizes, name, trunk, device)
        print(f"fine-grained {name}: {time.perf_counter() - t_m:.1f} s")
    del trunk
    torch.cuda.empty_cache()
    check_dcc(sizes, device)
    check_ae_fit(sizes, device)
    print(f"phase 18 (b): {time.perf_counter() - t_b:.1f} s")


def check_dcc(sizes: Sizes, device) -> None:
    """``solve_dcc`` at CUB-200's size (``sizes.dcc_split``: 5,994 train
    rows, num_samples 2,000, 64 bits) from seeded inputs on the card
    against the CPU: the share of equal database codes, and its time."""
    from concepthash_tpu_torch.losses.baselines import soften_sim, solve_dcc

    n_train, m = sizes.dcc_split
    nbit, nclass = sizes.head["nbit"], sizes.head["nclass"]
    rng = np.random.default_rng(79)
    labels = rng.integers(0, nclass, n_train)
    omega = rng.choice(n_train, m, replace=False)
    S = soften_sim(torch.from_numpy(
        (labels[omega][:, None] == labels[None, :]).astype(np.float32)
        * 2 - 1))
    U = torch.tanh(torch.from_numpy(rng.standard_normal((m, nbit))
                                    .astype(np.float32)))
    V = torch.from_numpy(np.sign(rng.standard_normal((n_train, nbit)))
                         .astype(np.float32))
    t0 = time.perf_counter()
    want = solve_dcc(V, U, S, omega, ADSH_GAMMA, nbit)
    cpu_s = time.perf_counter() - t0
    args = [t.to(device) for t in (V, U, S)]
    got = solve_dcc(*args[:3], omega, ADSH_GAMMA, nbit)
    agree = (got.cpu() == want).float().mean().item()
    ms = cuda_ms(lambda: solve_dcc(*args[:3], omega, ADSH_GAMMA, nbit), 3)
    print(f"solve_dcc (n_train {n_train}, |omega| {m}, nbit {nbit}) on the "
          f"card against the CPU: V agrees on {agree:.6f} of entries (limit "
          f"{MIN_DCC_AGREEMENT}), {(want != V).float().mean().item():.4f} "
          f"of the bits moved; {ms:.3f} ms on the card (CUDA events), "
          f"{cpu_s * 1e3:.1f} ms on the CPU")
    if agree < MIN_DCC_AGREEMENT or not set(got.unique().tolist()) <= {
            -1.0, 1.0}:
        fail(f"solve_dcc: the card's V agrees on {agree:.5f} of entries")


def check_ae_fit(sizes: Sizes, device) -> None:
    """``ae_fit`` for ``ae`` and ``induced_ae_norm_cossim`` on a seeded
    (200, 512) embedding to 64 bits, ``sizes.ae_iters[0]`` and ``[1]``
    iterations from one init on the card and on the CPU: signs agree on
    >= 99%; then ``ae``'s full ``sizes.ae_iters[2]`` iterations on the
    card, timed."""
    from concepthash_tpu_torch.train.codebook import ae_fit, ae_init

    n, d = sizes.ae_embedding
    nbit = sizes.head["nbit"]
    *it_cmp, it_full = sizes.ae_iters
    emb = np.random.default_rng(83).standard_normal((n, d)).astype(
        np.float32)
    for method, iters in zip(("ae", "induced_ae_norm_cossim"), it_cmp):
        init = ae_init(d, nbit, method)
        t0 = time.perf_counter()
        card = ae_fit(emb, nbit, method, iters=iters, init=init,
                      device=device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = ae_fit(emb, nbit, method, iters=iters, init=init,
                     device="cpu")
        cpu_s = time.perf_counter() - t0
        agree = float((np.sign(card) == np.sign(cpu)).mean())
        print(f"ae_fit {method} ({n} x {d} -> {nbit} bits, {iters} "
              f"iterations from one init): signs agree on {agree:.6f} (limit "
              f"{MIN_SIGN_AGREEMENT}), max |d| {np.abs(card - cpu).max():.3g};"
              f" {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
        if not np.isfinite(card).all() or agree < MIN_SIGN_AGREEMENT:
            fail(f"ae_fit {method}: signs agree on {agree:.4f}")
    t0 = time.perf_counter()
    full = ae_fit(emb, nbit, "ae", iters=it_full, device=device)
    torch.cuda.synchronize()
    print(f"ae_fit ae, the full {it_full} iterations on the card: "
          f"{time.perf_counter() - t0:.2f} s; codes finite: "
          f"{bool(np.isfinite(full).all())}")
    if not np.isfinite(full).all():
        fail("ae_fit: the full fit is not finite")


def run_finegrained(sizes: Sizes, device) -> None:
    """Phase 18 (a) and (b)."""
    t0 = time.perf_counter()
    finegrained_forwards(sizes, device)
    finegrained_steps(sizes, device)
    print(f"phase 18 (a), (b): {time.perf_counter() - t0:.1f} s")


def native_headers() -> bool:
    """Whether the C++ compiler finds libjpeg's and libpng's headers."""
    import shutil

    gxx = shutil.which("g++")
    if gxx is None:
        return False
    src = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
    proc = subprocess.run([gxx, "-fsyntax-only", "-x", "c++", "-"],
                          input=src, capture_output=True, text=True)
    return proc.returncode == 0


def run_loader(sizes: Sizes, device, tmp: str, argv, flagship: dict) -> None:
    """Phase 18 (d): the loader alone on phase 15's train PNGs, PIL against
    the C++ decode (where the library builds, as it must where the machine
    has libjpeg's and libpng's headers, the native route is required;
    where not, every image must go to PIL with the fallback logged), then
    the chunked flagship of phase 15 (c) again with ``cache_images=true``
    (its epoch losses and ``models/last.pt`` equal to the default run's bit
    for bit) and, where the library builds, with ``native_decode=true``:
    epoch-2 train img/s and the device's busy share beside the default
    run's."""
    import logging
    import os

    import main_gpu
    from concepthash_tpu_torch import native
    from concepthash_tpu_torch.data.manifest import HashingDataset
    from concepthash_tpu_torch.data.pipeline import Loader

    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.records = []

        def emit(self, record):
            self.records.append(record)

    t_d = time.perf_counter()
    headers = native_headers()
    root = os.path.join(tmp, "synth")
    ds = HashingDataset(root, "train.txt", sizes.flagship_classes)
    resize, batch = flagship["resize"], flagship["batch"]
    records = Warnings()
    logging.getLogger().addHandler(records)
    native.reset_counts()
    decoded = {}
    try:
        built = native.available()      # the build at first use
        for route in ("pil", "native"):
            loader = Loader(ds, batch, resize=resize,
                            native_decode=route == "native")
            t0 = time.perf_counter()
            decoded[route] = np.concatenate([b["image"][:b["n_valid"]]
                                             for b in loader])
            decoded[route + "_s"] = time.perf_counter() - t0
            loader.close()
    finally:
        logging.getLogger().removeHandler(records)
    n = len(ds)
    warned = any("native_decode" in r.getMessage() for r in records.records)
    rates = {r: n / decoded[r + "_s"] for r in ("pil", "native")}
    diff = float(np.abs(decoded["pil"].astype(np.int16)
                        - decoded["native"].astype(np.int16)).mean())
    print(f"loader: the C++ compiler finds jpeglib.h and png.h: {headers}; "
          f"the C++ decoder built and loaded: {built}")
    print(f"loader alone, {n} train PNGs at {resize}^2: PIL {rates['pil']:.1f}"
          f" img/s, native_decode {rates['native']:.1f} img/s; images by the "
          f"C++ decoder {native.counts['native']}, sent to PIL "
          f"{native.counts['fallback']}; the fallback logged: {warned}; mean "
          f"|PIL - native| {diff:.3f} per channel value")
    if headers and not built:
        fail("native_decode: the headers are there but the library did not "
             "build")
    if built and (native.counts["native"] != n or native.counts["fallback"]):
        fail("native_decode fell back to PIL where the library is there")
    if not built and (native.counts["fallback"] != n or not warned):
        fail("native_decode without its library: not every image went to "
             "PIL with the fallback logged")
    with open(os.path.join(tmp, "run", "train_history.json")) as f:
        default = json.load(f)
    last = torch.load(os.path.join(tmp, "run", "models", "last.pt"))["model"]
    rows = [("default (phase 15 (c))", flagship["train_img_s"],
             flagship["busy"])]
    runs = ["cache_images=true"] + (["native_decode=true"] if built
                                    else [])
    for extra in runs:
        run = os.path.join(tmp, "loader_" + extra.split("=")[0])
        exp = main_gpu.build_experiment(argv(run, extra))
        exp.main()
        with open(os.path.join(run, "train_history.json")) as f:
            train = json.load(f)
        epoch_s = train[1]["time"]
        steps = len(exp.loaders["train"])
        kernels = device_breakdown(f"{extra} flagship train epoch",
                                   lambda: exp.train_one_epoch(2), epoch_s,
                                   rows=4, warm=False)
        rows.append((extra, steps * batch / epoch_s,
                     busy_share(kernels, epoch_s)))
        if extra == "cache_images=true":
            sd = torch.load(os.path.join(run, "models", "last.pt"))["model"]
            same = ([r["loss"] for r in train]
                    == [r["loss"] for r in default]
                    and set(sd) == set(last)
                    and all(torch.equal(sd[k], last[k]) for k in last))
            print("cache_images=true against the default run: epoch losses "
                  + ", ".join(f"{r['loss']:.6f}" for r in train)
                  + " against " + ", ".join(f"{r['loss']:.6f}"
                                            for r in default)
                  + f"; models/last.pt equal: bit for bit {same} "
                  "(required)")
            if not same:
                fail("cache_images=true differs from the default run")
        for loader in exp.loaders.values():
            loader.close()
        del exp
    if not built:
        print("native_decode=true run: skipped, the C++ decoder cannot be "
              "built here (every image would go to PIL)")
    print("phase 18 (d) epoch-2 train img/s and device busy share, the "
          "chunked flagship: " + "; ".join(
              f"{name} {img_s:.1f} img/s, busy {100 * busy:.1f}%"
              for name, img_s, busy in rows)
          + f"; {card_line() if device.type == 'cuda' else 'the CPU'}")
    print(f"phase 18 (d): {time.perf_counter() - t_d:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: the unsupervised methods and the shallow regime
# ---------------------------------------------------------------------------

# each method's configs/model/*.yaml (unsup_greedyhash has none: cibhash's
# groups, its own loss at its defaults)
UNSUP_YAML = {"cibhash": "cibhash", "bihalf": "bihalf", "nsh": "nsh",
              "ssdh": "ssdh", "unsup_greedyhash": "cibhash", "itq": "itq"}
UNSUP_STEPPED = ("cibhash", "bihalf", "nsh", "ssdh", "unsup_greedyhash")
# the methods whose loss is held to fall over steps on one repeated batch
UNSUP_FALLS = ("cibhash", "nsh", "ssdh")
# the kernels' step against the plain one: sgd without weight decay, whose
# first update is the gradient. Adam's first update is the gradient's
# sign: a small gradient component, a scalar adapter scale's for one,
# turns over at full size (cosine -1) on a rounding.
UNSUP_SGD = {"name": "sgd", "lr": 0.001, "momentum": 0.9,
             "weight_decay": 0.0}
# Losses over straight-through signs taken in the forward: CIBHash's
# sign(p - 0.5) and Bi-half's sign against the batch median (whose two
# middle rows sit at the threshold on every bit). One bf16 rounding of the
# trunk moves codes across it, so the kernels' step and the plain step
# train on other binary codes (the update cosine over all trained
# tensors read 0.987 and 0.963, H100). For these the kernels are held on
# the backward of one loss gradient (``grads_at_one_cotangent``); the
# whole step's cosine is printed.
UNSUP_SIGN_DECIDED = ("cibhash", "bihalf")


def unsup_forwards(sizes: Sizes, device) -> None:
    """Phase 19 (a): the five unsupervised heads on one seeded trunk with
    adapters, and itq's descriptor on one without, each encode
    ``sizes.variant_images`` seeded images in bf16 on the card, counted
    (kernel 1 once a layer, no other kernel), against the same weights at
    float32 on the CPU, whose two trunks run once: codes agree in sign on
    >= 99% of bits; nsh's latents and the descriptor's features at mean
    row cosine >= 0.99."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.methods import build_model

    t_a = time.perf_counter()
    trunks = {ad: seeded_trunk(sizes, device, adapters=ad)
              for ad in (True, False)}
    vcfg = trunks[True].tower.cfg
    gen = torch.Generator(device=device).manual_seed(83)
    raw = torch.randint(0, 256, (sizes.variant_images, sizes.image_side,
                                 sizes.image_side, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    images = normalize(center_crop(raw, vcfg.image_size), 3)
    enc_cpu = {}
    for ad, trunk in trunks.items():
        cpu_trunk = seeded_trunk(sizes, torch.device("cpu"), like=trunk,
                                 adapters=ad)
        with torch.inference_mode():
            enc_cpu[ad] = cpu_trunk(images.float().cpu())
        del cpu_trunk
    expect = (vcfg.num_layers, 0, 0, 0, 0, 0)
    for name in (*UNSUP_STEPPED, "itq"):
        ad = name != "itq"
        cfg, cb, model, _ = baseline_on(sizes, name, trunks[ad], device)
        model.eval()
        torch.cuda.synchronize()
        count_reset()
        with torch.inference_mode():
            out = model(images)
        torch.cuda.synchronize()
        launches = counts()
        cpu, _ = build_model(dict(cfg, compute_dtype="float32"), cb,
                             device=torch.device("cpu"),
                             vision=dict(num_layers=0))
        cpu.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("backbone.")}, strict=False)
        cpu.backbone = GivenTrunk(enc_cpu[ad])
        with torch.inference_mode():
            want = cpu.eval()(images.float().cpu())
        held = {}
        if name == "itq":
            held["feature cosine"] = row_cosine(out["codes"], want["codes"])
        else:
            held["sign agreement"] = ((out["codes"].float().cpu() > 0)
                                      == (want["codes"] > 0)).float() \
                .mean().item()
        if name == "nsh":
            held["latent cosine"] = row_cosine(out["latents"],
                                               want["latents"])
        finite = all(torch.isfinite(v).all() for v in out.values())
        width = vcfg.hidden_size if name == "itq" else sizes.head["nbit"]
        print(f"unsupervised {name} encode ({sizes.variant_images} images, "
              f"bf16 on the card against f32 on the CPU"
              f"{'' if ad else ', no adapters'}): codes "
              f"{tuple(out['codes'].shape)}, "
              + ", ".join(f"{k} {v:.6f}" for k, v in held.items())
              + f" (limit {MIN_SIGN_AGREEMENT}); launches {launches} "
              f"against {expect}")
        if not finite or tuple(out["codes"].shape) != (
                sizes.variant_images, width):
            fail(f"unsupervised {name}: outputs not finite or of a wrong "
                 "shape")
        if any(v < MIN_SIGN_AGREEMENT for v in held.values()):
            fail(f"unsupervised {name}: {held} below {MIN_SIGN_AGREEMENT}")
        if launches != expect:
            fail(f"unsupervised {name}: launches {launches} != {expect}")
        del model, cpu, out, want
    print(f"phase 19 (a): {time.perf_counter() - t_a:.1f} s")
    del trunks
    torch.cuda.empty_cache()


def grads_at_one_cotangent(model, loss_fn, batch: dict) -> tuple:
    """The train forward with the kernels, the loss's gradient into the
    model's outputs, then that one cotangent back through the forward with
    the kernels and through one with their plain versions: (loss with the
    kernels, loss plain, the cosine of the two gradients over all trained
    tensors, {trained tensor: cosine})."""
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}

    def forward():
        out = model(batch["image"], train=True)
        keys = [k for k, v in out.items()
                if torch.is_tensor(v) and v.requires_grad]
        return out, keys

    out, keys = forward()
    total, _ = loss_fn(out, batch)
    cot = torch.autograd.grad(total, [out[k] for k in keys],
                              retain_graph=True, allow_unused=True)
    used = [(k, c) for k, c in zip(keys, cot) if c is not None]

    def grads(out):
        return torch.autograd.grad([out[k] for k, _ in used],
                                   list(trained.values()),
                                   grad_outputs=[c for _, c in used])

    g_k = grads(out)
    with plain_kernels():
        out_p, _ = forward()
        loss_p = float(loss_fn(out_p, batch)[0])
        g_p = grads(out_p)
    flat = [torch.cat([g.double().flatten() for g in gs]) for gs in (g_k,
                                                                     g_p)]
    return float(total), loss_p, \
        F.cosine_similarity(flat[0], flat[1], dim=0).item(), {
            n: F.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                   dim=0).item()
            for n, a, b in zip(trained, g_k, g_p)}


def unsup_images(sizes: Sizes, vcfg, device, seed: int) -> tuple:
    """A seeded batch of ``sizes.train_batch`` images: its two train views
    (crop, flip, TrivialAugment, drawn one after the other) and one-hot
    labels."""
    from concepthash_tpu_torch.data.preprocess import preprocess_batch

    gen = torch.Generator(device=device).manual_seed(seed)
    ops = torch.Generator().manual_seed(seed)
    B, nclass = sizes.train_batch, sizes.head["nclass"]
    raw = torch.randint(0, 256, (B, sizes.image_side, sizes.image_side, 3),
                        generator=gen, device=device, dtype=torch.uint8)
    views = [preprocess_batch(raw, gen, crop=vcfg.image_size, norm=3,
                              train=True, augment="trivial",
                              op_generator=ops) for _ in range(2)]
    y = torch.randint(0, nclass, (B,), generator=gen, device=device)
    return views, F.one_hot(y, nclass).float()


def unsup_steps(sizes: Sizes, device) -> None:
    """Phase 19 (b): five eager train steps each of cibhash, bihalf, nsh
    (two views: 2B = 64 image rows), ssdh (its structure block of the batch
    from the model's own eval codes as ``aux``) and unsup_greedyhash at
    B=32 at the kernel settings on one seeded batch, counted per step
    (kernels 5 and 6 once and twice a layer); the loss finite and, for
    cibhash, nsh and ssdh, falling; the frozen backbone bit-unchanged; a
    kernel step against a plain step under ``UNSUP_SGD``: loss within
    ``TRAIN_LOSS_RTOL``, the update's cosine over all trained tensors >=
    ``MIN_UPDATE_COSINE`` (adam's printed; for ``UNSUP_SIGN_DECIDED``
    printed, and the backward of one loss gradient held instead). Then
    graphed chunks of cibhash
    (two views) and ssdh (staged ``aux``) against eager steps, bit for
    bit; ``ssdh_structure`` and the four shallow fits timed at CUB-200's
    size."""
    from concepthash_tpu_torch.losses.unsupervised import ssdh_structure
    from concepthash_tpu_torch.methods import get_method, training_for

    t_b = time.perf_counter()
    trunk = seeded_trunk(sizes, device, TRAIN_VISION)
    vcfg = trunk.tower.cfg
    n_lay = vcfg.num_layers
    B, steps = sizes.train_batch, sizes.train_steps
    views, labels = unsup_images(sizes, vcfg, device, 89)
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if "adapter" not in k}
    expect = (0, 0, 0, 2 * n_lay, n_lay, 0)
    for name in UNSUP_STEPPED:
        t_m = time.perf_counter()
        cfg, cb, model, loss_fn = baseline_on(
            sizes, name, copy.deepcopy(trunk), device, TRAIN_VISION)
        two = get_method(name).two_view
        b = {"image": torch.cat(views) if two else views[0],
             "label": labels}
        extra = ""
        if name == "ssdh":
            model.eval()
            with torch.inference_mode():
                codes = model(views[0])["codes"].float().cpu().numpy()
            S = ssdh_structure(codes, alpha=float(cfg["criterion"]["alpha"]))
            b["aux"] = torch.from_numpy(S).to(device)
            extra = (f"; the batch's structure {100 * (S > 0).mean():.1f}% "
                     f"positive, {100 * (S < 0).mean():.1f}% negative")
        # the kernels' step against the plain one under sgd (no weight
        # decay: the update is the gradient), whose update cosine over all
        # trained tensors is held (UNSUP_SIGN_DECIDED: printed); adam's is
        # printed
        held = {}
        for opt, optim in (("adam", cfg["optim"]), ("sgd", UNSUP_SGD)):
            t = training_for(dict(cfg, optim=optim), model, loss_fn,
                             sizes.steps_per_epoch)
            loss_k, loss_p, upd_k, upd_p = steps_kernels_plain(t, b)
            cos = {n: F.cosine_similarity(upd_k[n], upd_p[n], dim=0).item()
                   for n in upd_k}
            worst = min(cos, key=cos.get)
            whole = F.cosine_similarity(torch.cat(list(upd_k.values())),
                                        torch.cat(list(upd_p.values())),
                                        dim=0).item()
            held[opt] = (loss_k, loss_p, whole)
            print(f"unsupervised {name} train step under {opt}, kernels vs "
                  f"plain: loss {loss_k:.6f} vs {loss_p:.6f}; update cosine "
                  f"over all trained tensors {whole:.6f}, per tensor min "
                  f"{cos[worst]:.6f} ({worst}), mean "
                  f"{sum(cos.values()) / len(cos):.6f}")
            del t
        loss_k, loss_p, whole = held["sgd"]
        if name in UNSUP_SIGN_DECIDED:
            loss_k, loss_p, whole, cos = grads_at_one_cotangent(model,
                                                                loss_fn, b)
            worst = min(cos, key=cos.get)
            print(f"unsupervised {name} train backward from one loss "
                  f"gradient, kernels vs plain: loss {loss_k:.6f} vs "
                  f"{loss_p:.6f}; gradient cosine over all trained tensors "
                  f"{whole:.6f}, per tensor min {cos[worst]:.6f} ({worst})")
        if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p) or \
                whole < MIN_UPDATE_COSINE:
            fail(f"unsupervised {name}: the kernels' step differs from its "
                 "plain version's")
        tr = training_for(cfg, model, loss_fn, sizes.steps_per_epoch)
        torch.cuda.synchronize()
        count_reset()
        losses, per_step, parts = [], [], []
        for i in range(steps):
            if i == 1:
                t0 = time.perf_counter()
            before = counts()
            m = tr.step(b)
            losses.append(float(m["loss"]))
            parts.append({k: float(v) for k, v in m.items() if k != "loss"})
            per_step.append(tuple(a - c for a, c in zip(counts(), before)))
        step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
        sd = model.backbone.state_dict()
        moved_frozen = [k for k, v in frozen.items()
                        if not torch.equal(sd[k], v)]
        print(f"unsupervised {name} train steps (B={B}, "
              f"{b['image'].shape[0]} image rows, kernels 5 and 6): loss "
              + ", ".join(f"{x:.5f}" for x in losses) + " ("
              + ", ".join(f"{k} {parts[0][k]:.4g} -> {parts[-1][k]:.4g}"
                          for k in parts[0])
              + f"); launches per step {per_step[0]} against {expect}, the "
              f"same every step: {len(set(per_step)) == 1}; frozen backbone "
              f"unchanged: {not moved_frozen}{extra}; {step_ms:.1f} ms a "
              "step after the first (host clock, eager)")
        if any(p != expect for p in per_step):
            fail(f"unsupervised {name}: launches per step {per_step}")
        if moved_frozen:
            fail(f"unsupervised {name}: frozen parameters moved: "
                 f"{moved_frozen[:3]}")
        falls = name not in UNSUP_FALLS or losses[-1] < losses[0]
        if not all(math.isfinite(x) for x in losses) or not falls:
            fail(f"unsupervised {name}: loss {losses} not finite or not "
                 "falling")
        del tr, model
        if name in ("cibhash", "ssdh"):
            baseline_graph_vs_eager(sizes, name, trunk, device,
                                    "unsupervised", views=1 + two,
                                    aux=name == "ssdh")
        print(f"unsupervised {name}: {time.perf_counter() - t_m:.1f} s")
    del trunk
    torch.cuda.empty_cache()
    unsup_fits(sizes)
    print(f"phase 19 (b): {time.perf_counter() - t_b:.1f} s")


def unsup_fits(sizes: Sizes) -> None:
    """``ssdh_structure`` over CUB-200's 5,994 train rows of 64-wide codes,
    and the four shallow fits (and their encode of the same rows) over
    5,994 768-wide features, host float64 as the reference's: seeded
    clustered rows, timed on the host clock."""
    from concepthash_tpu_torch.losses.shallow import FITTERS, encode_shallow
    from concepthash_tpu_torch.losses.unsupervised import ssdh_structure

    n, code_w, feat_w = sizes.unsup_fit
    nbit, nclass = sizes.head["nbit"], sizes.head["nclass"]
    rng = np.random.default_rng(101)
    cls = rng.integers(0, nclass, n)

    def clustered(width):
        return (rng.standard_normal((nclass, width))[cls]
                + rng.standard_normal((n, width))).astype(np.float32)

    codes, feats = clustered(code_w), clustered(feat_w)
    t0 = time.perf_counter()
    S = ssdh_structure(codes)
    s_s = time.perf_counter() - t0
    print(f"ssdh_structure ({n} x {code_w} codes, float64 on the host): "
          f"{s_s:.3f} s; {100 * (S > 0).mean():.2f}% positive, "
          f"{100 * (S < 0).mean():.2f}% negative; int8 {S.nbytes / 1e6:.1f} "
          f"MB, its float64 cosines {8 * n * n / 1e6:.1f} MB")
    if S.shape != (n, n) or not (np.diag(S) == 1).all() or \
            not (S < 0).any():
        fail("ssdh_structure: wrong shape, diagonal or no negatives")
    del S
    rows = []
    for name, fit in FITTERS.items():
        t0 = time.perf_counter()
        st = fit(feats, nbit)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = encode_shallow(st, feats)
        enc_s = time.perf_counter() - t0
        rows.append(f"{name} fit {fit_s:.3f} s, encode {enc_s:.3f} s")
        if out.shape != (n, nbit) or not np.isfinite(out).all():
            fail(f"shallow {name}: codes not finite of shape {(n, nbit)}")
    print(f"shallow fits ({n} x {feat_w} features to {nbit} bits, float64 "
          "on the host): " + "; ".join(rows))


def run_unsupervised(sizes: Sizes, device) -> None:
    """Phase 19 (a) and (b)."""
    t0 = time.perf_counter()
    unsup_forwards(sizes, device)
    unsup_steps(sizes, device)
    print(f"phase 19 (a), (b): {time.perf_counter() - t0:.1f} s")


def run_unsupervised_runs(sizes: Sizes, device, tmp: str, argv, eval_argv,
                          flagship: dict) -> None:
    """Phase 19 (c): ``model=cibhash`` (two views a step) and
    ``model=ssdh`` (its structure's shares printed) through
    ``run_model_runs``; then ``model=itq``, the shallow regime: kernel 1
    once a layer in every fit-extraction and eval batch, one test record
    with a mAP in [0, 1], the fit in ``models/best.pt`` and
    ``exp=validation`` raising its ValueError; the whole run's img/s."""
    import os

    import main_gpu

    t_c = time.perf_counter()

    def structure(exp):
        S = exp._structure
        n = len(exp.datasets["train"])
        print(f"ssdh structure over the {n} train images (int8): "
              f"{100 * (S > 0).mean():.2f}% positive, "
              f"{100 * (S < 0).mean():.2f}% negative, "
              f"{100 * (S == 0).mean():.2f}% ignored")
        if S.shape != (n, n) or S.dtype != np.int8 or \
                not (np.diag(S) == 1).all():
            fail("ssdh: the structure is not an int8 (n, n) matrix with a "
                 "unit diagonal")

    run_model_runs("phase 19 (c)", device, tmp, argv, eval_argv, flagship, (
        ("cibhash", {}), ("ssdh", {"check": structure})))
    print("phase 19 (c): cibhash's train img/s counts images; each takes "
          "two views through the trunk")

    run = os.path.join(tmp, "itq")
    exp = main_gpu.build_experiment(argv(run, "model=itq",
                                         *sizes.shallow_args))
    torch.cuda.synchronize()
    count_reset()
    t0 = time.perf_counter()
    best = exp.main()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    bs = int(exp.config["batch_size"])
    n_train = len(exp.datasets["train"])
    fit_batches = -(-n_train // bs)
    batches = fit_batches + len(exp.loaders["test"]) + len(exp.loaders["db"])
    want = (exp.model.vision_cfg.num_layers * batches, 0, 0, 0, 0, 0)
    with open(os.path.join(run, "test_history.json")) as f:
        test = json.load(f)
    blob = torch.load(os.path.join(run, "models", "best.pt"))
    fit = blob["criterion"]
    nbit = int(exp.config["model"]["nbit"])
    n_images = n_train + len(exp.datasets["test"]) + len(exp.datasets["db"])
    try:
        main_gpu.build_experiment(eval_argv("exp=validation",
                                            f"logdir={run}"))
        raised = ""
    except ValueError as e:
        raised = str(e)
    adapters = any("adapter" in k for k in exp.model.state_dict())
    print(f"itq run (the shallow regime, batch {bs}, adapters "
          f"{adapters}): "
          f"{fit_batches} fit-extraction batches through the train "
          f"augmentation, then the test and database encodes; launches "
          f"{launches} against {want}; test records {len(test)} at ep "
          f"{test[0]['ep']}, mAP {test[0]['mAP']:.6f}; models/best.pt "
          f"{{criterion: {fit['kind']}, r {tuple(fit['r'].shape)}}}, epoch "
          f"{blob['epoch']}; exp=validation raises ValueError: "
          f"{'not a network checkpoint' in raised}; the whole run "
          f"{run_s:.2f} s, {n_images / run_s:.1f} img/s ({n_images} images "
          f"through the trunk: {n_train} fit, the test and database "
          f"splits); {card_line() if device.type == 'cuda' else 'the CPU'}")
    if launches != want:
        fail("itq: kernel 1 not launched once a layer in every fit and "
             "eval batch, or another kernel launched")
    if len(test) != 1 or test[0]["ep"] != 0 or best != test[0]["mAP"] or \
            not 0.0 <= best <= 1.0:
        fail(f"itq: test records {test}")
    if fit["kind"] != "itq" or tuple(fit["r"].shape) != (nbit, nbit) or \
            blob["epoch"] != 0:
        fail("itq: models/best.pt does not hold the fit")
    if adapters:
        fail("itq: the descriptor's trunk has adapters")
    if "not a network checkpoint" not in raised:
        fail("itq: exp=validation on the shallow run did not raise its "
             "ValueError")
    del exp
    print(f"phase 19 (c): {time.perf_counter() - t_c:.1f} s")


# ---------------------------------------------------------------------------
# phase 20: the pretraining methods, TBH's adversarial step and the odc
# regime
# ---------------------------------------------------------------------------

# each method's configs/model/*.yaml
PRETRAIN_YAML = {"moco": "moco", "dino": "dino", "tbh": "tbh", "odc": "odc",
                 "mae": "mae", "autoencoder": "autoencoder"}
# the methods on the CLIP-adapter trunk (the others are the MAE net)
PRETRAIN_TRUNK = ("moco", "dino", "tbh", "odc")
# ODC's k-means at CUB-200's size (its memory's rows too): rows, code
# width and clusters
ODC_SIZE = (5994, 64, 200)


def mae_config(sizes: Sizes, name: str) -> dict:
    """The config dicts of configs/model/{mae,autoencoder}.yaml with
    dataset=cub200, in bf16: its encoder ViT-B/16 at 224^2 (``backbone:
    null``), or ``sizes.vision``'s geometry where given."""
    import os

    from concepthash_tpu_torch.config.loader import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs"), "train",
                      ["dataset=cub200", f"model={PRETRAIN_YAML[name]}",
                       "compute_dtype=bfloat16"])
    if sizes.vision:
        cfg["backbone"] = {"name": "cut", **sizes.vision}
    cfg["seed"] = 0
    return cfg


def pretrain_images(sizes: Sizes, side: int, device, n: int, seed: int):
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize

    gen = torch.Generator(device=device).manual_seed(seed)
    raw = torch.randint(0, 256, (n, sizes.image_side, sizes.image_side, 3),
                        generator=gen, device=device, dtype=torch.uint8)
    return normalize(center_crop(raw, side), 3)


def pretrain_forwards(sizes: Sizes, device) -> None:
    """Phase 20 (a): moco's, dino's, tbh's and odc's heads on one seeded
    trunk with adapters, and the MAE net of mae and autoencoder, each
    encode ``sizes.variant_images`` seeded images in bf16 on the card,
    counted (kernel 1 once a layer, no other kernel), against the same
    weights at float32 on the CPU: tbh's and odc's codes agree in sign on
    >= 99% of bits, moco's and dino's projections (moco's predictions too)
    and the MAE's features at mean row cosine >= 0.99. Then kernel 1
    against its plain version at the MAE's shape (B=64, L=196, exact GELU,
    no adapters), timed."""
    from concepthash_tpu_torch.methods import build_model

    t_a = time.perf_counter()
    trunk = seeded_trunk(sizes, device)
    vcfg = trunk.tower.cfg
    images = pretrain_images(sizes, vcfg.image_size, device,
                             sizes.variant_images, 97)
    cpu_trunk = seeded_trunk(sizes, torch.device("cpu"), like=trunk)
    with torch.inference_mode():
        enc_cpu = cpu_trunk(images.float().cpu())
    del cpu_trunk

    def held_line(label, out, held, launches, expect):
        finite = all(torch.isfinite(v).all() for v in out.values()
                     if torch.is_tensor(v))
        print(f"pretrain {label} encode ({sizes.variant_images} images, "
              f"bf16 on the card against f32 on the CPU): codes "
              f"{tuple(out['codes'].shape)}, "
              + ", ".join(f"{k} {v:.6f}" for k, v in held.items())
              + f" (at least {MIN_SIGN_AGREEMENT}); kernel launches "
              f"{launches} (want {expect})")
        if not finite:
            fail(f"pretrain {label}: outputs not finite")
        if any(v < MIN_SIGN_AGREEMENT for v in held.values()):
            fail(f"pretrain {label}: {held} below {MIN_SIGN_AGREEMENT}")
        if launches != expect:
            fail(f"pretrain {label}: launches {launches} != {expect}")

    expect = (vcfg.num_layers, 0, 0, 0, 0, 0)
    for name in PRETRAIN_TRUNK:
        cfg, cb, model, _ = baseline_on(sizes, name, trunk, device)
        torch.cuda.synchronize()
        count_reset()
        with torch.inference_mode():
            out = model(images)
        torch.cuda.synchronize()
        launches = counts()
        cpu, _ = build_model(dict(cfg, compute_dtype="float32"), cb,
                             device=torch.device("cpu"),
                             vision=dict(num_layers=0))
        cpu.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("backbone.")}, strict=False)
        cpu.backbone = GivenTrunk(enc_cpu)
        with torch.inference_mode():
            want = cpu(images.float().cpu())
        if name in ("tbh", "odc"):
            held = {"sign agreement": ((out["codes"].float().cpu() > 0)
                                       == (want["codes"] > 0)).float()
                    .mean().item()}
        else:
            held = {k + " cosine": row_cosine(out[k], want[k])
                    for k in ("proj", "pred") if k in out}
        held_line(name, out, held, launches, expect)
        del model, cpu, out, want
    del trunk, enc_cpu
    torch.cuda.empty_cache()

    # the MAE net: mae and autoencoder build it from one seed, alike
    models = {}
    for name in ("mae", "autoencoder"):
        cfg = mae_config(sizes, name)
        models[name], _ = build_model(cfg, None, device=device)
    sd = models["mae"].state_dict()
    same = all(torch.equal(sd[k], v)
               for k, v in models["autoencoder"].state_dict().items())
    mcfg = models["mae"].cfg
    images = pretrain_images(sizes, mcfg.image_size, device,
                             sizes.variant_images, 98)
    cpu, _ = build_model(dict(mae_config(sizes, "mae"),
                              compute_dtype="float32"), None,
                         device=torch.device("cpu"))
    cpu.load_state_dict({k: v.cpu() for k, v in sd.items()})
    with torch.inference_mode():
        want = cpu(images.float().cpu())
    del cpu
    expect = (mcfg.enc_layers, 0, 0, 0, 0, 0)
    print(f"MAE net (encoder {mcfg.enc_dim} x {mcfg.enc_layers} layers x "
          f"{mcfg.enc_heads} heads over {mcfg.num_patches} patches of "
          f"{mcfg.patch_size}^2, decoder {mcfg.dec_dim} x "
          f"{mcfg.dec_layers} x {mcfg.dec_heads}): mae's and autoencoder's "
          f"seeded weights equal: {same}")
    if not same:
        fail("mae and autoencoder: one seed gives two MAE nets")
    for name, model in models.items():
        torch.cuda.synchronize()
        count_reset()
        with torch.inference_mode():
            out = model(images)
        torch.cuda.synchronize()
        held_line(name, out,
                  {"feature cosine": row_cosine(out["features"],
                                                want["features"])},
                  counts(), expect)
    del models, images, want
    torch.cuda.empty_cache()
    check_mae_layer(sizes, mcfg, device)
    print(f"phase 20 (a): {time.perf_counter() - t_a:.1f} s")


def check_mae_layer(sizes: Sizes, mcfg, device) -> dict:
    """Kernel 1 at the MAE encoder's shape (B = ``sizes.variant_images``,
    L = the patches, D, F = 4D, exact GELU, no adapters) against its
    plain version within ``LAYER_ATOL + LAYER_RTOL |ref|``; timed with its
    plain version and the library composition, beside its bound."""
    from concepthash_tpu_torch.ops import fused_layer as fl

    gen = torch.Generator().manual_seed(23)
    B, L, D = sizes.variant_images, mcfg.num_patches, mcfg.enc_dim
    F_, H = 4 * D, mcfg.enc_heads
    w, _, _ = random_layer(gen, D, F_, 0, False, device)
    x = torch.randn(B, L, D, generator=gen).to(device, torch.bfloat16)
    kw = dict(num_heads=H, eps=1e-5, act="gelu")
    got = fl.encoder_layer_cuda(x, w, **kw).float()
    torch.cuda.synchronize()
    want = fl.layer_reference(x, w, **kw).float()
    err = (got - want).abs()
    excess = (err - (LAYER_ATOL + LAYER_RTOL * want.abs())).max().item()
    with torch.inference_mode():
        ms = cuda_ms(lambda: fl.encoder_layer_cuda(x, w, **kw), sizes.reps)
        plain_ms = cuda_ms(lambda: fl.layer_reference(x, w, **kw), 3)
        lib_w = fl.LayerWeights(*(t.to(torch.bfloat16) for t in w))
        lib_ms = cuda_ms(lambda: layer_library(x, lib_w, None, None, H,
                                               1e-5, act="gelu"), sizes.reps)
    flops, nbytes = layer_flops_bytes(B, L, D, F_, 0, 0, w, ())
    bound = max(flops / BF16_PEAK, nbytes / HBM_RATE) * 1e3
    by = "operations" if flops / BF16_PEAK >= nbytes / HBM_RATE else "bytes"
    print(f"kernel 1 at the MAE encoder's shape against its plain version, "
          f"B={B} L={L} D={D} F={F_} H={H} gelu, no adapters: max |d| "
          f"{err.max().item():.6g}, mean |d| {err.mean().item():.3g}, max "
          f"|ref| {want.abs().max().item():.4g}; kernel {ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP), plain "
          f"{plain_ms:.4f} ms, library (F.linear + SDPA) {lib_ms:.4f} ms; "
          f"{flops / ms / 1e9:.1f} TFLOP/s; "
          f"{card_line() if device.type == 'cuda' else 'the CPU'}")
    if not torch.isfinite(got).all() or excess > 0:
        fail(f"layer kernel at the MAE shape outside |d| <= {LAYER_ATOL} + "
             f"{LAYER_RTOL}|ref|")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound}


def pretrain_state(tr):
    """A record of ``tr``'s whole train state (the model, the optimizer,
    the schedule, the generator and the method's extras) to restore it."""
    from concepthash_tpu_torch.train.state import create_train_state

    st = create_train_state(tr.model, tr.optimizer, tr.scheduler,
                            {"dropout": tr.generator}, extra=tr.extra)
    return st, copy.deepcopy((tr.model.state_dict(), st.state_dict()))


def pretrain_kernels_plain(tr, batch: dict) -> tuple:
    """One step of ``tr`` with the kernels and one from the same state (the
    method's extras included) with their plain versions: (loss with the
    kernels, loss plain, the update's cosine over all trained tensors)."""
    trained = {n: p for n, p in tr.model.named_parameters()
               if p.requires_grad}
    st, snap = pretrain_state(tr)
    start = {n: p.detach().clone() for n, p in trained.items()}

    def one_step():
        tr.generator.manual_seed(1)
        loss = float(tr.step(batch)["loss"])
        upd = torch.cat([(p.detach() - start[n]).double().flatten()
                         for n, p in trained.items()])
        tr.model.load_state_dict(snap[0])
        st.load_state_dict(copy.deepcopy(snap[1]))
        return loss, upd

    loss_k, upd_k = one_step()
    with plain_kernels():
        loss_p, upd_p = one_step()
    return loss_k, loss_p, F.cosine_similarity(upd_k, upd_p, dim=0).item()


def odc_memory(n: int, nbit: int, k: int, device, seed: int) -> dict:
    """ODC's memory at ``n`` rows: clustered L2-normalized codes, their
    seeded labels, the clusters' means and unit weights."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, k, (n,), generator=gen)
    feats = torch.randn(k, nbit, generator=gen)[labels] \
        + 0.5 * torch.randn(n, nbit, generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    cents = torch.zeros(k, nbit).index_add_(0, labels, feats) / \
        torch.bincount(labels, minlength=k).clamp_min(1)[:, None]
    return {"features": feats.to(device), "labels": labels.to(device),
            "centroids": cents.to(device),
            "weights": torch.ones(k, device=device)}


def pretrain_steps(sizes: Sizes, device) -> None:
    """Phase 20 (b): five counted eager steps each of moco, dino (two views,
    2B = 64 image rows), tbh and odc at B=32 at the kernel settings on one
    seeded batch (kernels 5 and 6: 2 and 4 trunk forwards a step for the
    teacher methods, 1 for tbh and odc), and of mae and autoencoder at the
    config's B=64 (no kernel in their train forward); the loss finite; the
    frozen backbone bit-unchanged; for the trunk's four a kernel step
    against a plain step under ``UNSUP_SGD`` (loss within
    ``TRAIN_LOSS_RTOL``, the update's cosine over all trained tensors >=
    ``MIN_UPDATE_COSINE``; adam turns rounding-sized gradients into
    full-size updates, 0.971-0.992 on the H100). Held besides: moco's teacher
    at the schedule's momentum after each step (dino's at its constant
    one) and dino's center moving; tbh's discriminator moving with its own
    Adam's step count; odc's memory rows outside the batch bit-unchanged
    and the refresh on the steps whose count is a multiple of the
    interval. Then the port's k-means at CUB-200's size on the card
    against the CPU's run of the same code."""
    from concepthash_tpu_torch.methods import (build_model, get_method,
                                               training_for)
    from concepthash_tpu_torch.train.pretrain_steps import cosine_momentum

    t_b = time.perf_counter()
    trunk = seeded_trunk(sizes, device, TRAIN_VISION)
    vcfg = trunk.tower.cfg
    n_lay = vcfg.num_layers
    B, steps = sizes.train_batch, sizes.train_steps
    views, labels = unsup_images(sizes, vcfg, device, 91)
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if "adapter" not in k}
    n_odc, k_odc = ODC_SIZE[0], sizes.head["nclass"]
    for name in (*PRETRAIN_TRUNK, "mae", "autoencoder"):
        t_m = time.perf_counter()
        on_trunk = name in PRETRAIN_TRUNK
        if on_trunk:
            cfg, cb, model, loss_fn = baseline_on(
                sizes, name, copy.deepcopy(trunk), device, TRAIN_VISION)
            cfg["_train_size_"] = n_odc
            two = get_method(name).two_view
            b = {"image": torch.cat(views) if two else views[0],
                 "label": labels}
            forwards = 4 if two else 1
            expect = (0, 0, 0, 2 * n_lay * forwards, n_lay * forwards, 0)
        else:
            cfg = mae_config(sizes, name)
            model, loss_fn = build_model(cfg, None, device=device)
            mb = int(cfg["batch_size"])
            b = {"image": pretrain_images(sizes, model.cfg.image_size,
                                          device, mb, 92),
                 "label": labels[:1].expand(mb, -1)}
            expect = (0, 0, 0, 0, 0, 0)
        if name == "odc":
            gen = torch.Generator().manual_seed(3)
            b["index"] = torch.randperm(n_odc, generator=gen)[:B].to(device)
        memory = (odc_memory(n_odc, sizes.head["nbit"], k_odc, device, 5)
                  if name == "odc" else None)

        def fresh(optim=None):
            t = training_for(dict(cfg, optim=optim or cfg["optim"]), model,
                             loss_fn, sizes.steps_per_epoch)
            for key, v in (memory or {}).items():
                t.extra[key].copy_(v)
            return t

        if on_trunk:
            loss_k, loss_p, whole = pretrain_kernels_plain(fresh(UNSUP_SGD),
                                                           b)
            print(f"pretrain {name} train step under sgd, kernels vs plain: "
                  f"loss {loss_k:.6f} vs {loss_p:.6f}; update cosine over "
                  f"all trained tensors {whole:.6f}")
            if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p) or \
                    whole < MIN_UPDATE_COSINE:
                fail(f"pretrain {name}: the kernels' step differs from its "
                     "plain version's")
        tr = fresh()
        ex = tr.extra
        disc0 = ({k: v.clone() for k, v in ex["disc"].state_dict().items()}
                 if "disc" in ex else None)
        torch.cuda.synchronize()
        count_reset()
        losses, per_step, notes = [], [], []
        total = int(cfg["epochs"]) * sizes.steps_per_epoch
        for i in range(steps):
            if i == 1:
                t0 = time.perf_counter()
            before = counts()
            if "teacher" in ex:
                t_before = [p.detach().clone()
                            for p in ex["teacher"].parameters()]
            if name == "odc":
                mem_before = ex["features"].clone()
                cents_before = ex["centroids"].clone()
            m = tr.step(b)
            losses.append(float(m["loss"]))
            per_step.append(tuple(a - c for a, c in zip(counts(), before)))
            if "teacher" in ex:
                mom = (cosine_momentum(i, total,
                                       float(cfg["criterion"]["momentum"]))
                       if name == "moco"
                       else float(cfg["criterion"]["momentum"]))
                with torch.no_grad():
                    d = max((t * mom + s * (1.0 - mom) - p).abs().max().item()
                            for t, s, p in zip(t_before,
                                               tr.model.parameters(),
                                               ex["teacher"].parameters()))
                notes.append(d)
            if name == "odc":
                rest = torch.ones(n_odc, dtype=torch.bool, device=device)
                rest[b["index"]] = False
                kept = torch.equal(ex["features"][rest], mem_before[rest])
                refreshed = not torch.equal(ex["centroids"], cents_before)
                interval = int(cfg["criterion"].get(
                    "update_interval", cfg["criterion"].get(
                        "cluster_interval", 10)))
                notes.append((kept, refreshed, i % interval == 0))
        step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
        extra = ""
        if "teacher" in ex:
            extra = (f"; the teacher equals teacher * m + student * (1 - m) "
                     f"at each step's momentum within "
                     f"{max(notes):.3g}")
            if max(notes) > 1e-6:
                fail(f"pretrain {name}: the teacher did not move by the "
                     "momentum")
        if name == "dino":
            moved = ex["center"].abs().max().item()
            extra += f"; center max |c| {moved:.4g}"
            if not moved > 0:
                fail("dino: the center did not move")
        if name == "tbh":
            moved = max((v - disc0[k]).abs().max().item()
                        for k, v in ex["disc"].state_dict().items())
            d_steps = {int(s["step"]) for s in
                       ex["disc_opt"].state_dict()["state"].values()}
            extra += (f"; the discriminator moved max |d| {moved:.4g} from "
                      f"its seeded init, its Adam at step {d_steps}")
            if not moved > 0 or d_steps != {steps}:
                fail("tbh: the discriminator did not take its own steps")
        if name == "odc":
            kept = all(k for k, _, _ in notes)
            fired = [r for _, r, _ in notes]
            due = [d for _, _, d in notes]
            extra += (f"; memory rows outside the batch bit-unchanged: "
                      f"{kept}; refresh fired {fired}, due {due}")
            if not kept or fired != due:
                fail("odc: the memory or the refresh is wrong")
        if on_trunk:
            sd = tr.model.backbone.state_dict()
            moved_frozen = [k for k, v in frozen.items()
                            if not torch.equal(sd[k], v)]
        else:
            moved_frozen = []
        print(f"pretrain {name} train steps (B={b['image'].shape[0]} image "
              f"rows): loss " + ", ".join(f"{x:.5f}" for x in losses)
              + f"; kernel launches a step {per_step[0]} (want {expect}), "
              f"alike every step: {len(set(per_step)) == 1}; frozen "
              f"backbone unchanged: {not moved_frozen}{extra}; "
              f"{step_ms:.1f} ms a step after the first (host clock, "
              "eager)")
        if any(p != expect for p in per_step):
            fail(f"pretrain {name}: launches per step {per_step}")
        if moved_frozen or not all(math.isfinite(x) for x in losses):
            fail(f"pretrain {name}: frozen parameters moved or the loss is "
                 "not finite")
        del tr, model
        print(f"pretrain {name}: {time.perf_counter() - t_m:.1f} s")
    del trunk
    torch.cuda.empty_cache()
    mae_graph_vs_eager(sizes, device)
    check_kmeans(device)
    print(f"phase 20 (b): {time.perf_counter() - t_b:.1f} s")


def mae_graph_vs_eager(sizes: Sizes, device) -> None:
    """Phase 20 (b): the MAE at its config's B=64, whose mask is a uniform
    draw from the run's generator inside the step, in two chunks of
    ``sizes.graph_chunk`` steps through ``make_multi_train_step`` (a
    warm-up, then a replay) against as many eager steps of a twin built
    from the same seed, bit for bit: the losses, the parameters and the
    generator's state. A replay that drew one mask again, or left the
    generator where the capture found it, would differ in both."""
    from concepthash_tpu_torch.methods import build_model, training_for
    from concepthash_tpu_torch.train.state import make_multi_train_step

    t0 = time.perf_counter()
    cfg = mae_config(sizes, "mae")
    trs = []
    for _ in range(2):
        model, loss_fn = build_model(cfg, None, device=device)
        trs.append(training_for(cfg, model, loss_fn, sizes.steps_per_epoch))
    graph, eager = trs
    K, mb = sizes.graph_chunk, int(cfg["batch_size"])
    side = graph.model.cfg.image_size
    label = torch.zeros(mb, sizes.head["nclass"], device=device)
    batches = [{"image": pretrain_images(sizes, side, device, mb, 100 + i),
                "label": label} for i in range(2 * K)]
    stacked = [{k: torch.stack([b[k] for b in batches[c * K:(c + 1) * K]])
                for k in batches[0]} for c in range(2)]
    start = graph.generator.get_state()
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    g_loss = [x for chunk in stacked for x in multi(chunk)["loss"].tolist()]
    e_loss = [float(eager.step(b)["loss"]) for b in batches]
    gs, es = graph.model.state_dict(), eager.model.state_dict()
    d = max((gs[k].float() - es[k].float()).abs().max().item() for k in gs)
    g_state = graph.generator.get_state()
    same_gen = torch.equal(g_state, eager.generator.get_state()) and \
        not torch.equal(g_state, start)
    same = g_loss == e_loss and d == 0.0 and same_gen
    print(f"mae graph vs eager train (K={K}, B={mb}, a warm-up chunk and a "
          f"replay, the mask drawn in the step): losses "
          + ", ".join(f"{x:.5f}" for x in g_loss[K:]) + " / "
          + ", ".join(f"{x:.5f}" for x in e_loss[K:])
          + f" (the replay's), parameters max |d| {d:.3g}, the generator "
          f"advanced to the eager twin's state: {same_gen}: bit for bit "
          f"{same} (required) with {getattr(multi, 'replays', 0)} replays; "
          f"{time.perf_counter() - t0:.1f} s")
    if not same:
        fail("mae: the graphed chunk differs from eager steps (losses, "
             "parameters or the mask generator)")
    del graph, eager, trs, batches, stacked



def check_kmeans(device) -> None:
    """The port's k-means (k-means++ and Lloyd's, the best of 3) at
    ``ODC_SIZE`` (CUB-200's train rows, 64-wide codes, 200 clusters) on
    seeded clustered unit rows, on the card against the CPU's run of the
    same code, which draws its seeds on the host: labels equal on >= 99%
    of rows, both timed."""
    from concepthash_tpu_torch.train.kmeans import kmeans

    n, nbit, k = ODC_SIZE
    x = odc_memory(n, nbit, k, torch.device("cpu"), 7)["features"]
    runs = {}
    for dev in (device, torch.device("cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, cents, inertia = kmeans(x.to(dev), k, seed=0)
        torch.cuda.synchronize()
        runs[dev.type] = (labels.cpu(), inertia, time.perf_counter() - t0)
    (lc, ic, sc), (lh, ih, sh) = runs[device.type], runs["cpu"]
    agree = (lc == lh).float().mean().item()
    print(f"k-means ({n} x {nbit} unit rows, {k} clusters, 3 inits, "
          f"float64) on {device.type}: {sc:.3f} s, inertia {ic:.6f}; on the "
          f"CPU {sh:.3f} s, inertia {ih:.6f}; equal labels on {agree:.6f} "
          f"of rows (limit {MIN_SIGN_AGREEMENT}); "
          f"{card_line() if device.type == 'cuda' else 'the CPU'}")
    if agree < MIN_SIGN_AGREEMENT or len(lc.unique()) != k:
        fail("k-means: the card's labels differ from the CPU's")


def run_pretrain(sizes: Sizes, device) -> None:
    """Phase 20 (a) and (b)."""
    t0 = time.perf_counter()
    pretrain_forwards(sizes, device)
    pretrain_steps(sizes, device)
    print(f"phase 20 (a), (b): {time.perf_counter() - t0:.1f} s")


def run_pretrain_runs(sizes: Sizes, device, tmp: str, argv, eval_argv,
                      flagship: dict) -> None:
    """Phase 20 (c): ``main_gpu.py model=moco`` and ``model=mae`` (exp
    general: kernel 1 once a layer in every test batch of both evaluations,
    no other kernel; two finite train records and two test records with
    their ``test_loss``) and a moco run resumed after epoch 1 equal to the
    uninterrupted one bit for bit (the parameters and the teacher); then
    ``model=tbh`` and ``model=odc`` through ``run_model_runs`` (odc's
    k-means encode of the train split counted, its NMI lines and test
    records checked). Epoch-2 train and eval img/s beside phase 15's
    flagship."""
    import os

    import main_gpu

    t_c = time.perf_counter()
    rows = [("flagship (phase 15)", flagship["train_img_s"],
             flagship["eval_img_s"])]
    for model in ("moco", "mae"):
        run = os.path.join(tmp, model)
        exp = main_gpu.build_experiment(argv(run, f"model={model}"))
        secs = time_encodes(exp)
        torch.cuda.synchronize()
        count_reset()
        t0 = time.perf_counter()
        exp.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        with open(os.path.join(run, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(run, "test_history.json")) as f:
            test = json.load(f)
        n_layers = (exp.model.cfg.enc_layers if model == "mae"
                    else exp.model.vision_cfg.num_layers)
        want = (n_layers * 2 * len(exp.loaders["test"]), 0, 0, 0, 0, 0)
        steps, batch = exp.steps_per_epoch, int(exp.config["batch_size"])
        rows_a_step = batch * (2 if exp.method.two_view else 1)
        print(f"{model} run (exp {exp.config['exp']}, train_chunk "
              f"{exp.train_chunk}, {steps} steps of {batch} images, "
              f"{rows_a_step} image rows a step): train records "
              + "; ".join(f"ep {r['ep']} loss {r['loss']:.5f} "
                          f"{r['time']:.2f} s" for r in train)
              + "; test_loss " + ", ".join(f"{r['test_loss']:.4g}"
                                          for r in test)
              + f"; graph replays "
              f"{getattr(exp.train_multi_step, 'replays', 0)} train; "
              f"launches {launches} against {want}; the run {run_s:.1f} s")
        if len(train) != 2 or len(test) != 2 or not all(
                math.isfinite(r["loss"]) for r in train) or any(
                "test_loss" not in r for r in test):
            fail(f"{model}: not two finite train records and two test "
                 "records with test_loss")
        if launches != want:
            fail(f"{model}: kernel 1 not launched once a layer and test "
                 "batch, or another kernel launched")
        rows.append((model, steps * batch / train[1]["time"],
                     eval_img_s(exp, secs)[1]))
        for loader in exp.loaders.values():
            loader.close()
        del exp
        if model == "moco":
            check_resume(model, tmp, run, train, argv, "model=moco",
                         extras=("teacher",))
    print("phase 20 (c): moco's train img/s counts images; each takes two "
          "views through the student and the teacher")

    def nmi(exp):
        with open(os.path.join(exp.logdir, "test_history.json")) as f:
            test = json.load(f)
        with open(os.path.join(exp.logdir, "log.txt")) as f:
            log = f.read()
        vals = [(r["test_nmi"], r["db_nmi"]) for r in test]
        print(f"odc: the k-means logged: {'initial k-means' in log}; NMI "
              f"(test, db) by evaluation {vals}")
        if "initial k-means" not in log or "test NMI" not in log or \
                not all(0.0 <= v <= 1.0 for pair in vals for v in pair):
            fail("odc: no k-means or NMI in the run")

    run_model_runs("phase 20 (c), tbh and odc", device, tmp, argv,
                   eval_argv, flagship, (
                       ("tbh", {"single": True}),
                       ("odc", {"single": True, "check": nmi})))
    print("phase 20 (c) img/s, epoch-2 train and eval encode, train_chunk "
          "auto: " + "; ".join(f"{n} train {t:.1f}, eval {e:.1f}"
                               for n, t, e in rows)
          + f"; {card_line() if device.type == 'cuda' else 'the CPU'}")
    print(f"phase 20 (c): {time.perf_counter() - t_c:.1f} s")


# ---------------------------------------------------------------------------
# phase 21: the non-CLIP trunks, reference-checkpoint import, profile, debug
# ---------------------------------------------------------------------------

# a train step's running statistics against a recomputation from the batch
BN_STATS_ATOL = 1e-5
# the port's kernel names in a trace (csrc/fused_layer.cu, attention.cu)
PORT_KERNEL_NAMES = ("gemm_kernel", "attention_mma_kernel",
                     "layernorm_kernel")


def trunk_config(sizes: Sizes, group: str, yaml: str = "orthohash_adapter",
                 name: str | None = None) -> dict:
    """The config dicts of ``configs/model/<yaml>.yaml`` on the backbone
    ``group`` (dataset=cub200: 224^2 crops) at ``sizes``' nbit and nclass,
    in bf16, seed 0, with ``sizes.trunk_args`` and the group's
    ``sizes.trunk_over`` overrides (the CPU rehearsal's cuts)."""
    import os

    from concepthash_tpu_torch.config.loader import load_config

    over = dict(sizes.trunk_over).get(group, ())
    cfg = load_config(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs"),
        "train", ["dataset=cub200", f"model={yaml}", f"backbone={group}",
                  "compute_dtype=bfloat16", *sizes.trunk_args, *over])
    cfg["model"].update(nclass=sizes.head["nclass"], nbit=sizes.head["nbit"])
    if name is not None:
        cfg["model"]["name"] = name
    cfg["seed"] = 0
    return cfg


def trunk_model(cfg: dict, device, vision=None) -> tuple:
    """(codebook, the config's seeded model on ``device``, its loss)."""
    from concepthash_tpu_torch.methods import (build_model, get_method,
                                               prepare_codebook)

    cb = prepare_codebook(get_method(cfg["model"]["name"]), cfg)
    model, loss_fn = build_model(cfg, cb, device=device, vision=vision)
    return cb, model, loss_fn


def trunk_models(cfg: dict, device) -> tuple:
    """(the config's seeded model on ``device``, the same weights at
    float32 on the CPU)."""
    from concepthash_tpu_torch.methods import build_model

    cb, model, _ = trunk_model(cfg, device)
    cpu, _ = build_model(dict(cfg, compute_dtype="float32"), cb,
                         device=torch.device("cpu"))
    cpu.load_state_dict(model.state_dict())
    return model, cpu


def trunk_images(sizes: Sizes, cfg: dict, n: int, device, seed: int):
    """``n`` seeded uint8 images at ``sizes.trunk_side``, center-cropped to
    the config's crop and normalized by its ``norm``."""
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize

    gen = torch.Generator(device=device).manual_seed(seed)
    raw = torch.randint(0, 256, (n, sizes.trunk_side, sizes.trunk_side, 3),
                        generator=gen, device=device, dtype=torch.uint8)
    ds = cfg["dataset"]
    return normalize(center_crop(raw, int(ds["crop"])), int(ds["norm"]))


def trunk_layers(model) -> int:
    """Kernel 1's launches an encode: a vit trunk's layers, else none."""
    vcfg = model.backbone.vision_cfg
    return vcfg.num_layers if vcfg is not None else 0


def trunk_encode(sizes: Sizes, group: str, device, yaml="orthohash_adapter",
                 name=None) -> dict:
    """One trunk's encode of ``sizes.trunk_images`` images, bf16 on the card
    against f32 on the CPU (the first ``sizes.trunk_cpu_images``), counted;
    returns its row of numbers."""
    cfg = trunk_config(sizes, group, yaml, name)
    t0 = time.perf_counter()
    model, cpu = trunk_models(cfg, device)
    build_s = time.perf_counter() - t0
    images = trunk_images(sizes, cfg, sizes.trunk_images, device, 71)
    n_cpu = min(sizes.trunk_cpu_images, sizes.trunk_images)
    model.eval()
    cpu.eval()
    torch.cuda.synchronize()
    count_reset()
    with torch.inference_mode():
        out = model(images)
    torch.cuda.synchronize()
    launches = counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu(images[:n_cpu].float().cpu())
        feats_c = cpu.backbone(images[:n_cpu].float().cpu())["features"]
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        feats = model.backbone(images[:n_cpu])["features"]
    codes, ref = out["codes"][:n_cpu].float().cpu(), want["codes"]
    agree = ((codes > 0) == (ref > 0)).float().mean().item()
    cos = row_cosine(feats, feats_c)
    logit_err = {k: ((out[k][:n_cpu].float().cpu() - want[k]).abs().max()
                     / want[k].abs().max()).item()
                 for k in ("logits",) if k in want}
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(images), sizes.reps)
    expect = (trunk_layers(model), 0, 0, 0, 0, 0)
    finite = all(torch.isfinite(v).all() for v in out.values())
    label = name or group
    print(f"trunk {label} encode ({sizes.trunk_images} images at "
          f"{images.shape[1]}^2, bf16 on the card; the first {n_cpu} "
          f"against f32 on the CPU): codes {tuple(out['codes'].shape)}, "
          f"bits agreeing {agree:.6f} (limit {MIN_SIGN_AGREEMENT}), "
          f"features {tuple(feats.shape)} at cosine {cos:.6f} "
          f"(limit {MIN_FEATURE_COSINE}); "
          + "".join(f"{k} within {v:.4g} of the largest (limit "
                    f"{LOGIT_RTOL}); " for k, v in logit_err.items())
          + f"launches {launches} against {expect}; {ms:.3f} ms an encode "
          f"({sizes.trunk_images / ms * 1e3:.1f} img/s); built in "
          f"{build_s:.1f} s, the CPU's f32 encode {cpu_s:.1f} s")
    if not finite or codes.shape[0] != n_cpu:
        fail(f"trunk {label}: outputs not finite")
    if agree < MIN_SIGN_AGREEMENT or cos < MIN_FEATURE_COSINE:
        fail(f"trunk {label}: bits agree {agree:.4f}, features cosine "
             f"{cos:.4f}")
    if any(v > LOGIT_RTOL for v in logit_err.values()):
        fail(f"trunk {label}: logits {logit_err} beyond {LOGIT_RTOL}")
    if launches != expect:
        fail(f"trunk {label}: launches {launches} != {expect}")
    return {"group": label, "img_s": sizes.trunk_images / ms * 1e3,
            "agree": agree, "cos": cos}


def check_layer_at(sizes: Sizes, label: str, B: int, L: int, D: int, F_: int,
                   H: int, device) -> dict:
    """Kernel 1 against its plain version at a vit trunk's shape (exact
    GELU, eps 1e-6, both adapters at ``sizes.bottleneck``), then timed
    beside its plain version and ``layer_library`` (F.linear + SDPA)."""
    from concepthash_tpu_torch.ops import fused_layer as fl

    gen = torch.Generator().manual_seed(17)
    w, a1, a2 = random_layer(gen, D, F_, sizes.bottleneck, True, device)
    x = torch.randn(B, L, D, generator=gen).to(device, torch.bfloat16)
    kw = dict(num_heads=H, eps=1e-6, act="gelu", adapter_attn=a1,
              adapter_mlp=a2)
    with torch.inference_mode():
        got = fl.encoder_layer_cuda(x, w, **kw)
        torch.cuda.synchronize()
        want = fl.layer_reference(x, w, **kw)
    err = check_close(f"layer kernel at the {label} trunk's shape, B={B} "
                      f"L={L} D={D} F={F_} H={H} gelu, both adapters "
                      f"({sizes.bottleneck})", got, want, LAYER_ATOL,
                      LAYER_RTOL)
    with torch.inference_mode():
        ms = cuda_ms(lambda: fl.encoder_layer_cuda(x, w, **kw), sizes.reps)
        plain_ms = cuda_ms(lambda: fl.layer_reference(x, w, **kw), 3)
        lw = fl.LayerWeights(*(t.to(torch.bfloat16) for t in w))
        la = [fl.AdapterWeights(*(t.to(torch.bfloat16) for t in a))
              for a in (a1, a2)]
        lib_ms = cuda_ms(lambda: layer_library(x, lw, *la, H, 1e-6,
                                               act="gelu"), sizes.reps)
    flops, nbytes = layer_flops_bytes(B, L, D, F_, sizes.bottleneck, 2, w,
                                      (a1, a2))
    bound = max(flops / BF16_PEAK, nbytes / HBM_RATE) * 1e3
    print(f"encoder_layer at the {label} trunk's shape (B={B}, L={L}, "
          f"D={D}, both adapters): kernel {ms:.4f} ms, bound {bound:.4f} "
          f"ms, plain {plain_ms:.4f} ms, library (F.linear + SDPA) "
          f"{lib_ms:.4f} ms; "
          f"{card_line() if device.type == 'cuda' else 'the CPU'}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound}


def trunk_forwards(sizes: Sizes, device) -> None:
    """Phase 21 (a): each trunk of ``sizes.trunk_groups`` under orthohash's
    head, and a2net_ce on resnet50's grid; kernel 1 at the vit trunks' two
    new shapes."""
    t_a = time.perf_counter()
    rows = [trunk_encode(sizes, g, device) for g in sizes.trunk_groups]
    rows.append(trunk_encode(sizes, "resnet50", device, "a2net_ce_adapter",
                             "a2net_ce"))
    for group in ("vit_s16", "vit_b16"):
        if group not in sizes.trunk_groups:
            continue
        cfg = trunk_config(sizes, group)
        b = cfg["backbone"]
        L = (int(b["image_size"]) // int(b["patch_size"])) ** 2 + 1
        check_layer_at(sizes, group, sizes.trunk_images, L,
                       int(b["hidden_size"]), int(b["intermediate_size"]),
                       int(b["num_heads"]), device)
    print("phase 21 (a) encode img/s, bf16, orthohash's head: "
          + "; ".join(f"{r['group']} {r['img_s']:.1f}" for r in rows)
          + f"; {card_line() if device.type == 'cuda' else 'the CPU'}")
    print(f"phase 21 (a): {time.perf_counter() - t_a:.1f} s")
    torch.cuda.empty_cache()


def bn_inputs(model) -> tuple:
    """Forward pre-hooks on every BatchNorm of the trunk that keep, in the
    next train forward, each one's running statistics before it and the
    biased batch statistics of its input (float64, two passes): (the
    hooks, {name: (mean0, var0, mean, var)})."""
    from concepthash_tpu_torch.models.layers import CodeBatchNorm

    seen, hooks = {}, []
    for n, m in model.backbone.named_modules():
        if not isinstance(m, CodeBatchNorm):
            continue

        def hook(mod, args, n=n):
            x = args[0].double()
            dims = [d for d in range(x.dim()) if d != 1]
            seen[n] = (mod.running_mean.clone(), mod.running_var.clone(),
                       x.mean(dims), x.var(dims, correction=0))
        hooks.append(m.register_forward_pre_hook(hook))
    return hooks, seen


def trunk_steps(sizes: Sizes, device) -> None:
    """Phase 21 (b): five eager steps of orthohash on each trunk of
    ``TRUNK_TRAINED`` at ``sizes.trunk_batch`` (vit at the kernel
    settings, kernels 5 and 6 counted), the loss finite and falling (vgg16:
    finite; its dropout masks differ every step); the
    BatchNorm statistics of the first step against a recomputation from
    the batch; resnet18's frozen BatchNorm bit-unchanged; vgg16's dropout
    from the run's generator; vit's kernel step against a plain one under
    sgd; then graphed chunks of ``TRUNK_GRAPHED`` against eager
    steps bit for bit, buffers included."""
    from concepthash_tpu_torch.methods import training_for

    t_b = time.perf_counter()
    nclass = sizes.head["nclass"]
    B = sizes.trunk_batch
    for group in TRUNK_TRAINED:
        t_m = time.perf_counter()
        cfg = trunk_config(sizes, group)
        vit = cfg["backbone"]["family"] == "vit"
        _, model, loss_fn = trunk_model(cfg, device,
                                        TRAIN_VISION if vit else None)
        dgen = torch.Generator(device=device).manual_seed(73)
        y = torch.randint(0, nclass, (B,), generator=dgen, device=device)
        batch = {"image": trunk_images(sizes, cfg, B, device, 74),
                 "label": F.one_hot(y, nclass).float()}
        n_lay = trunk_layers(model)
        expect = (0, 0, 0, 2 * n_lay, n_lay, 0)
        extra = ""
        if vit:     # the kernels' step against the plain one under sgd
            t = training_for(dict(cfg, optim=UNSUP_SGD), model, loss_fn,
                             sizes.steps_per_epoch)
            loss_k, loss_p, upd_k, upd_p = steps_kernels_plain(t, batch)
            whole = F.cosine_similarity(torch.cat(list(upd_k.values())),
                                        torch.cat(list(upd_p.values())),
                                        dim=0).item()
            print(f"trunk {group} train step under sgd, kernels vs plain: "
                  f"loss {loss_k:.6f} vs {loss_p:.6f}; update cosine over "
                  f"all trained tensors {whole:.6f}")
            if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p) or \
                    whole < MIN_UPDATE_COSINE:
                fail(f"trunk {group}: the kernels' step differs from its "
                     "plain version's")
            del t
        tr = training_for(cfg, model, loss_fn, sizes.steps_per_epoch)
        replay = None
        if cfg["backbone"]["family"] == "vgg16":
            replay = dropout_replay(tr, batch)
        buffers = {k: v.clone() for k, v in model.backbone.named_buffers()}
        frozen = {k: v.clone() for k, v in model.backbone.named_parameters()
                  if not v.requires_grad}
        hooks, seen = bn_inputs(model)
        torch.cuda.synchronize()
        count_reset()
        losses, per_step, gen_states = [], [], [tr.generator.get_state()]
        for i in range(sizes.train_steps):
            if i == 1:
                t0 = time.perf_counter()
            before = counts()
            losses.append(float(tr.step(batch)["loss"]))
            per_step.append(tuple(a - c for a, c in zip(counts(), before)))
            gen_states.append(tr.generator.get_state())
            if i == 0:
                for h in hooks:
                    h.remove()
                stats_d = bn_stats_d(model, seen)
        step_ms = (time.perf_counter() - t0) / (sizes.train_steps - 1) * 1e3
        after = dict(model.backbone.named_buffers())
        params = dict(model.backbone.named_parameters())
        moved = [k for k, v in frozen.items() if not torch.equal(params[k], v)]
        if cfg["backbone"].get("frozen_bn"):
            same = all(torch.equal(after[k], v) for k, v in buffers.items())
            extra = (f"; frozen BatchNorm buffers (num_batches_tracked "
                     f"included) bit-unchanged after {len(losses)} steps: "
                     f"{same}")
            if not same:
                fail(f"trunk {group}: frozen_bn moved a buffer")
        elif seen:
            counted = {int(v) for k, v in after.items()
                       if k.endswith("num_batches_tracked")}
            extra = (f"; the first step's running statistics against 0.9 r "
                     f"+ 0.1 (batch mean, biased variance): max |d| "
                     f"{stats_d:.3g} (limit {BN_STATS_ATOL}) over "
                     f"{len(seen)} BatchNorms; num_batches_tracked "
                     f"{sorted(counted)}")
            if stats_d > BN_STATS_ATOL or counted != {len(losses)}:
                fail(f"trunk {group}: running statistics {stats_d} off, or "
                     f"num_batches_tracked {counted}")
        if replay is not None:
            advanced = all(not torch.equal(a, b)
                           for a, b in zip(gen_states, gen_states[1:]))
            extra += (f"; dropout from the run's generator: it advanced "
                      f"every step {advanced}, a step replayed from one "
                      f"state alike and from another not: {replay}")
            if not advanced or not replay:
                fail(f"trunk {group}: dropout not drawn from the run's "
                     "generator")
        print(f"trunk {group} train steps (B={B}"
              + (", kernels 5 and 6" if vit else "") + "): loss "
              + ", ".join(f"{x:.5f}" for x in losses)
              + f"; launches per step {per_step[0]} against {expect}, the "
              f"same every step: {len(set(per_step)) == 1}; frozen "
              f"parameters unchanged: {not moved}{extra}; {step_ms:.1f} ms "
              "a step after the first (host clock, eager)")
        if any(p != expect for p in per_step):
            fail(f"trunk {group}: launches per step {per_step}")
        # a dropout trunk's loss moves with its masks (rate 0.5 at fc6 and
        # fc7), so only its finiteness is held
        falls = replay is not None or losses[-1] < losses[0]
        if moved or not all(math.isfinite(x) for x in losses) or not falls:
            fail(f"trunk {group}: loss {losses} not finite or not falling, "
                 f"or frozen parameters moved {moved[:3]}")
        del tr, model
        if group in TRUNK_GRAPHED:
            trunk_graph_vs_eager(sizes, group, device)
        print(f"trunk {group}: {time.perf_counter() - t_m:.1f} s")
    print(f"phase 21 (b): {time.perf_counter() - t_b:.1f} s")
    torch.cuda.empty_cache()


def bn_stats_d(model, seen: dict) -> float:
    """The largest |d| between each BatchNorm's running statistics and
    0.9 r0 + 0.1 (batch mean, biased batch variance) of what ``seen``
    kept in the last train forward."""
    mods = dict(model.backbone.named_modules())
    worst = 0.0
    for n, (m0, v0, mean, var) in seen.items():
        m = mods[n]
        worst = max(worst, (m.running_mean.double() - (
            0.9 * m0.double() + 0.1 * mean)).abs().max().item(),
            (m.running_var.double() - (0.9 * v0.double() + 0.1 * var))
            .abs().max().item())
    return worst


def dropout_replay(tr, batch: dict) -> bool:
    """One step of ``tr`` from one dropout generator state twice gives one
    loss, and from another state another (the state restored after
    each)."""
    model = tr.model
    snap = (copy.deepcopy(model.state_dict()),
            copy.deepcopy(tr.optimizer.state_dict()),
            copy.deepcopy(tr.scheduler.state_dict()),
            tr.generator.get_state())
    losses = []
    for seed in (1, 1, 2):
        tr.generator.manual_seed(seed)
        losses.append(float(tr.step(batch)["loss"]))
        model.load_state_dict(snap[0])
        tr.optimizer.load_state_dict(snap[1])
        tr.scheduler.load_state_dict(snap[2])
    tr.generator.set_state(snap[3])
    return losses[0] == losses[1] != losses[2]


def trunk_graph_vs_eager(sizes: Sizes, group: str, device) -> None:
    """Two chunks of ``sizes.check_chunk`` orthohash steps on the trunk
    through ``make_multi_train_step`` (a warm-up, then a replay) against
    as many eager steps of a twin from the same seed: losses, parameters
    and buffers (BatchNorm statistics, ``num_batches_tracked``) bit for
    bit, and the dropout generator's state."""
    from concepthash_tpu_torch.methods import training_for
    from concepthash_tpu_torch.train.state import make_multi_train_step

    sizes = check_sizes(sizes)
    cfg = trunk_config(sizes, group)
    vit = cfg["backbone"]["family"] == "vit"
    trs = []
    for _ in range(2):
        _, model, loss_fn = trunk_model(cfg, device,
                                        TRAIN_VISION if vit else None)
        trs.append(training_for(cfg, model, loss_fn, sizes.steps_per_epoch))
    graph, eager = trs
    K, B, nclass = sizes.graph_chunk, sizes.trunk_batch, sizes.head["nclass"]
    dgen = torch.Generator(device=device).manual_seed(75)
    batches = []
    for i in range(2 * K):
        y = torch.randint(0, nclass, (B,), generator=dgen, device=device)
        batches.append({"image": trunk_images(sizes, cfg, B, device, 80 + i),
                        "label": F.one_hot(y, nclass).float()})
    stacked = [{k: torch.stack([b[k] for b in batches[c * K:(c + 1) * K]])
                for k in batches[0]} for c in range(2)]
    multi = make_multi_train_step(graph.model, graph.loss_fn,
                                  graph.optimizer, graph.scheduler,
                                  generator=graph.generator)
    g_loss = [x for chunk in stacked for x in multi(chunk)["loss"].tolist()]
    e_loss = [float(eager.step(b)["loss"]) for b in batches]
    gs, es = graph.model.state_dict(), eager.model.state_dict()
    d = max((gs[k].double() - es[k].double()).abs().max().item() for k in gs)
    n_buf = sum(1 for k, _ in graph.model.named_buffers())
    same_gen = torch.equal(graph.generator.get_state(),
                           eager.generator.get_state())
    same = g_loss == e_loss and d == 0.0 and same_gen
    n_lay = trunk_layers(graph.model)
    want = ({"ln_matmul_cuda": 2 * K * n_lay, "attention_cuda": K * n_lay}
            if n_lay else {})
    per_replay = getattr(multi, "launches_per_replay", want)
    print(f"trunk {group} graph vs eager train (K={K}, a warm-up chunk and "
          f"a replay): losses {g_loss[-1]:.5f} / {e_loss[-1]:.5f} at the "
          f"last step, state max |d| {d:.3g} over the parameters and "
          f"{n_buf} buffers, the dropout generator alike {same_gen}: "
          f"graphed steps alike bit for bit: {same} (required), "
          f"{getattr(multi, 'replays', 0)} replays, launches per replay "
          f"{per_replay}")
    if not same:
        fail(f"trunk {group}: graphed steps differ from eager ones")
    if per_replay != want:
        fail(f"trunk {group}: launches per replay {per_replay} != {want}")
    del graph, eager, trs


def run_trunks(sizes: Sizes, device) -> None:
    """Phase 21 (a) and (b)."""
    t0 = time.perf_counter()
    trunk_forwards(sizes, device)
    trunk_steps(sizes, device)
    print(f"phase 21 (a), (b): {time.perf_counter() - t0:.1f} s")


def reference_layout(sd: dict) -> dict:
    """A port orthohash-on-ResNet state dict renamed into the reference's
    layout: the trunk under ``backbone.model.``, the hash layer and its
    BatchNorm as ``hash_fc.0`` / ``hash_fc.1``, the centroids and the
    codebook buffer."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone.tower."):
            out["backbone.model." + k[len("backbone.tower."):]] = v
        elif k.startswith("hash_bn."):
            out["hash_fc.1." + k[len("hash_bn."):]] = v
        elif k == "hash_fc.weight":
            out["hash_fc.0.weight"] = v
        else:
            out[k] = v
    out["hash_fc.1.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    out["codebook"] = sd["ce_fc.centroids"]
    return out


# the calls whose algorithm a library picks by the operands' shapes
LIBRARY_CALLS = ("conv2d", "linear", "matmul", "bmm", "baddbmm", "addmm",
                 "mm", "einsum", "scaled_dot_product_attention")


def batch_variant_call(model, images: torch.Tensor, n: int) -> tuple:
    """Eval forwards of the first ``n`` rows of ``images`` and of all B,
    compared call by call: every torch call's tensor result, in order. A
    result that leads with n and B times one factor (batch-major, as Swin's
    windows are) is held on the n images' rows, one of the same shape
    whole; any other is not held. Returns (results held equal before the
    first that differs, that call's name or None, its max |d|, the small
    pass's codes, the big pass's codes)."""
    from torch.overrides import TorchFunctionMode

    B = images.shape[0]
    kept: list = []
    state = {"i": 0, "held": 0, "first": None, "d": 0.0}

    class Calls(TorchFunctionMode):
        def __init__(self, keep: bool):
            super().__init__()
            self.keep = keep

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", repr(func))
            if not isinstance(out, torch.Tensor) or name.startswith(
                    ("empty", "new_empty")):    # contents not yet written
                return out
            if self.keep:
                kept.append(out.detach().clone())
                return out
            i = state["i"]
            state["i"] += 1
            if state["first"] is not None or i >= len(kept):
                return out
            ref, kept[i] = kept[i], None      # freed as the pass goes
            if out.shape == ref.shape:
                got = out
            elif out.dim() and out.shape[1:] == ref.shape[1:] and \
                    out.shape[0] * n == ref.shape[0] * B:
                got = out[:ref.shape[0]]
            else:
                return out
            if torch.equal(got, ref):
                state["held"] += 1
            else:
                state["first"] = name
                state["d"] = (got.float() - ref.float()).abs().max().item()
                kept.clear()
            return out

    head = images[:n]
    with torch.inference_mode():
        with Calls(True):
            small = model(head, train=False)["codes"].float()
        with Calls(False):
            big = model(images, train=False)["codes"].float()[:n]
    return state["held"], state["first"], state["d"], small, big


def batch_shape_witness(label: str, run: str, eval_argv, device,
                        hold: bool = False) -> None:
    """Phase 21 (c): why a CNN run's ``exp=validation`` at
    configs/val.yaml's batch may not give back the mAP the run scored at
    its own: the run's last model encodes the first test rows inside a
    batch of half val.yaml's (the run's 32 on the card) and inside one of
    val.yaml's. Held: that half batch encoded twice gives the same codes
    bit for bit, and the first call whose rows differ between the two
    shapes is a library's (``LIBRARY_CALLS``: cuDNN's convolutions,
    cuBLAS's products), every call of the port's own before it equal.
    Read, not held: the codes that flip sign and how near 0 they were, the
    same with cuDNN held to deterministic algorithms (benchmark off), and
    the validation's mAP at val.yaml's batch against the run's, which
    ``hold`` holds within 1e-6."""
    import os

    import main_gpu
    from concepthash_tpu_torch.data.preprocess import preprocess_batch

    ev = main_gpu.build_experiment(eval_argv(
        "exp=validation", f"logdir={run}", "use_last=true"))
    exp = ev.exp
    batch = next(iter(exp.loaders["test"]))
    images = preprocess_batch(
        torch.from_numpy(np.asarray(batch["image"][:batch["n_valid"]])).to(
            device), crop=exp.crop, norm=exp.norm, train=False)
    B = images.shape[0]
    n = max(1, B // 2)
    with torch.inference_mode():
        once = exp.model(images[:n], train=False)["codes"]
        twice = exp.model(images[:n], train=False)["codes"]
    repeat = torch.equal(once, twice)
    readings = {}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    for mode, det in (("default", False), ("cudnn deterministic", True)):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            (det, False) if det else flags
        held, first, d, small, big = batch_variant_call(exp.model, images, n)
        flip = torch.sign(small) != torch.sign(big)
        near = small.abs()[flip]
        readings[mode] = first
        print(f"{label} batch shapes ({mode}): {n} test rows inside a batch "
              f"of {n} and of {B}: {held} call results equal, then "
              + (f"{first} differs (max |d| {d:.3g})" if first else
                 "none differs")
              + f"; codes max |d| {(small - big).abs().max().item():.3g}, "
              f"{int(flip.sum())} of {flip.numel()} signs flip, at |code| "
              f"<= {near.max().item() if near.numel() else 0.0:.3g} "
              f"(median |code| {small.abs().median().item():.3g})")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    with open(os.path.join(run, "test_history.json")) as f:
        run_map = json.load(f)[-1]["mAP"]
    got = ev.main()
    for loader in exp.loaders.values():
        loader.close()
    d_map = abs(got["mAP"] - run_map)
    print(f"{label} exp=validation use_last=true at val.yaml's batch of "
          f"{int(exp.config['batch_size'])}: mAP {got['mAP']:.6f} against "
          f"the run's {run_map:.6f}, |d| {d_map:.3g} "
          + (f"(limit {REPLAY_MAP_ATOL})" if hold else "(read, not held)")
          + f"; the half batch twice bit for bit: {repeat} (required); the "
          "first call that differs a library's: "
          f"{readings['default'] in (None, *LIBRARY_CALLS)} (required)")
    if not repeat or readings["default"] not in (None, *LIBRARY_CALLS):
        fail(f"{label}: the codes follow the batch's shape through the "
             f"port's own code ({readings['default']}), or a batch encoded "
             "twice differs")
    if hold and d_map > REPLAY_MAP_ATOL:
        fail(f"{label}: exp=validation does not reproduce the run")
    del ev, exp


def run_trunk_runs(sizes: Sizes, device, tmp: str, argv, eval_argv,
                   flagship: dict) -> None:
    """Phase 21 (c) and (d) on phase 15's synthetic set."""
    import os

    import main_gpu

    t_c = time.perf_counter()
    ortho, dpsh, csq = "orthohash_adapter", "dpsh_adapter", "csq_adapter"
    r50, vit, swin = "resnet50", "vit_b16", "swin_base"
    vit_over = dict(sizes.trunk_over).get(vit, ())
    # resnet50 validates at the run's batch size: cuDNN picks its
    # convolutions' algorithms by the batch's shape, and with them the
    # codes' last bits (batch_shape_witness shows it); swin_base at
    # val.yaml's, as its witness finds no call that follows the shape
    run_model_runs("phase 21 (c)", device, tmp, argv, eval_argv, flagship, (
        (ortho, {"name": f"{ortho}_{r50}",
                 "extra": (f"backbone={r50}",
                           *dict(sizes.trunk_over).get(r50, ())),
                 "resume": True, "val_at_run_batch": True}),
        (csq, {"name": f"{csq}_{swin}",
               "extra": (f"backbone={swin}",
                         *dict(sizes.trunk_over).get(swin, ()))})))
    for name in (f"{ortho}_{r50}", f"{csq}_{swin}"):
        batch_shape_witness(name, os.path.join(tmp, name), eval_argv,
                            device)
    def counted_run(label: str, *extra) -> dict:
        run = os.path.join(tmp, f"{dpsh}_{vit}_{label}")
        exp = main_gpu.build_experiment(argv(run, f"model={dpsh}",
                                             f"backbone={vit}", *vit_over,
                                             *extra))
        if label == "profiled":     # the window: the epoch's last step,
            steps = exp.steps_per_epoch     # the evaluation, the next step
            exp.profiler.start_step = steps - 1
            exp.profiler.num_steps = 2
        secs = time_encodes(exp)
        torch.cuda.synchronize()
        count_reset()
        exp.main()
        torch.cuda.synchronize()
        launches = counts()
        with open(os.path.join(run, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(run, "test_history.json")) as f:
            test = json.load(f)
        n_eval = exp.epochs * (len(exp.loaders["test"])
                               + len(exp.loaders["db"]))
        want = (trunk_layers(exp.model) * n_eval, 0, 0, 0, 0, 0)
        batch = int(exp.config["batch_size"])
        out = {"run": run, "train": train, "test": test,
               "profiler": exp.profiler,
               "eval_img_s": eval_img_s(exp, secs)[1],
               "train_img_s": (exp.steps_per_epoch * batch / train[-1]["time"])}
        print(f"{dpsh} on {vit} run ({label}, train_chunk "
              f"{exp.train_chunk}): train records "
              + "; ".join(f"ep {r['ep']} loss {r['loss']:.6f}" for r in train)
              + "; test mAP " + ", ".join(f"{r['mAP']:.6f}" for r in test)
              + f"; graph replays "
              f"{getattr(exp.train_multi_step, 'replays', 0)} train, "
              f"{getattr(exp.eval_multi_step, 'replays', 0)} eval; launches "
              f"{launches} against {want}")
        if not len(train) == len(test) == exp.epochs or launches != want:
            fail(f"{dpsh} on {vit} ({label}): records or launches wrong")
        if exp.train_chunk != 1 or exp.train_multi_step is not None \
                or exp.eval_multi_step is not None:
            fail(f"{dpsh} on {vit} ({label}): something was captured")
        for loader in exp.loaders.values():
            loader.close()
        return out

    # one step a dispatch, traced over the first evaluation (models/ep1.pt
    # kept), then its first epoch again under debug.disable_jit
    profiled = counted_run("profiled", "train_chunk=1", "save_interval=1",
                           "+profile.enabled=true")
    eager = counted_run("disable_jit", "epochs=1", "+debug.disable_jit=true")
    prof = profiled["profiler"]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    port = sorted({k for k in PORT_KERNEL_NAMES
                   if any(k in n for n in names)})
    print(f"profile: the trace {os.path.basename(prof.trace_path)} of "
          f"dispatches {prof.start_step}-{prof.start_step + prof.num_steps - 1}"
          f" ({len(events)} events) names the port's kernels {port}; "
          f"{len(prof.step_times)} dispatches timed")
    if not events or (device.type == "cuda" and not port):
        fail("profile: no trace, or no kernel of the port in it")
    r1 = profiled["run"]
    a = torch.load(os.path.join(r1, "models", "ep1.pt"))["model"]
    b = torch.load(os.path.join(eager["run"], "models", "last.pt"))["model"]
    d = max((a[k].float() - b[k].float()).abs().max().item() for k in a)
    same = profiled["train"][0]["loss"] == eager["train"][0]["loss"] and \
        d == 0.0 and set(a) == set(b)
    print(f"debug.disable_jit run against the train_chunk=1 run's first "
          f"epoch: its loss and models/ep1.pt max |d| {d:.3g}: bit for bit "
          f"{same} (required)")
    if not same:
        fail("debug.disable_jit: the run differs from its train_chunk=1 run")
    print(f"{dpsh} on {vit}: epoch-2 train {profiled['train_img_s']:.1f} "
          f"img/s at train_chunk 1, eval {profiled['eval_img_s']:.1f} img/s;"
          f" {card_line() if device.type == 'cuda' else 'the CPU'}")
    # validated at val.yaml's batch: kernel 1 gives a row the same bits in
    # any batch (the witness finds no call that follows the shape)
    batch_shape_witness(f"{dpsh} on {vit}", r1, eval_argv, device, hold=True)
    import_reference_run(device, tmp, argv, eval_argv, ortho, r50,
                         dict(sizes.trunk_over).get(r50, ()))
    print(f"phase 21 (c), (d): {time.perf_counter() - t_c:.1f} s")


def import_reference_run(device, tmp: str, argv, eval_argv, model: str,
                         group: str, over: tuple = ()) -> None:
    """Phase 21 (d): a seeded port ``model`` on ``group`` renamed into the
    reference's layout (``reference_layout``), saved as a ``.pth``, through
    ``scripts/import_reference_checkpoint_torch.py`` and ``exp=validation``:
    the imported state and the test split's codes equal the seeded model's
    bit for bit."""
    import os
    import sys

    import main_gpu

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    try:
        import import_reference_checkpoint_torch as script
    finally:
        sys.path.pop(0)
    from concepthash_tpu_torch.config.loader import load_config
    from concepthash_tpu_torch.methods import (build_model, get_method,
                                               prepare_codebook)

    t0 = time.perf_counter()
    over = (f"backbone={group}", *over)
    args = [a for a in argv("unused", f"model={model}", *over)
            if not a.startswith(("--device", "logdir="))
            and a != str(device)]
    out = os.path.join(tmp, "imported")
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs"), "train", [*args, f"logdir={out}"])
    cb = prepare_codebook(get_method(cfg["model"]["name"]), cfg)
    seeded = build_model(cfg, cb, device=torch.device("cpu"))[0].state_dict()
    pth = os.path.join(tmp, "reference_best.pth")
    torch.save(reference_layout(seeded), pth)
    res = script.main(["--pth", pth, "--outdir", out, *args])
    report = res["report"]
    imported = torch.load(os.path.join(out, "models", "best.pt"))["model"]
    same_sd = set(imported) == set(seeded) and all(
        torch.equal(imported[k], seeded[k]) for k in seeded)
    ev = main_gpu.build_experiment(eval_argv("exp=validation",
                                             f"logdir={out}"))
    res_map = ev.main()["mAP"]
    codes = ev.exp.encode_split("test")[0]["codes"]
    ev.exp.model.load_state_dict(seeded)
    want = ev.exp.encode_split("test")[0]["codes"]
    same = torch.equal(codes, want)
    print(f"reference-layout import ({len(seeded)} tensors of {model} on "
          f"{group} renamed into the reference's keys): {len(report.written)}"
          f" written, unused {report.unused}, missing {report.missing}; the "
          f"imported state equal to the seeded one: {same_sd}; "
          f"exp=validation mAP {res_map:.6f}, test codes "
          f"{tuple(codes.shape)} equal to the seeded model's bit for bit: "
          f"{same} (required); {time.perf_counter() - t0:.1f} s")
    if report.unused or report.missing or not same_sd or not same:
        fail("the reference-layout import does not reproduce the seeded "
             "model")
    for loader in ev.exp.loaders.values():
        loader.close()
    del ev


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return [y for item in x for y in _flatten(item)]
    return [x]


def run(sizes: Sizes, device) -> dict:
    from concepthash_tpu_torch import _build
    from concepthash_tpu_torch.data.preprocess import center_crop, normalize
    from concepthash_tpu_torch.ops import fused_layer as fl
    from concepthash_tpu_torch.ops import topk_select as ts
    from concepthash_tpu_torch.ops.retrieval import (exact_topk_blocked,
                                                     retrieve_topk,
                                                     retrieve_topk_streaming,
                                                     sign_distances)

    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s wall ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in build_s.items()) + ")")

    model, vcfg = build_model(sizes, device)
    nbit, k = model.cfg.nbit, sizes.k
    layer_err = check_layer(sizes, vcfg, device)
    mins_err, mins_plain_err = check_mins(sizes, device)
    ln_err = check_ln_matmul(sizes, vcfg, device)
    attn_err = check_attention(sizes, vcfg, device)

    # ---- inputs of the main path, made on the device from seeds ----
    gen = torch.Generator(device=device).manual_seed(0)
    raw = torch.randint(0, 256, (sizes.images, sizes.image_side,
                                 sizes.image_side, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    N = sizes.gallery
    gallery = torch.randint(0, 2, (N, nbit), generator=gen, device=device,
                            dtype=torch.int8) * 2 - 1
    planted = torch.randperm(N, generator=gen, device=device)[:sizes.images]
    torch.cuda.synchronize()

    # ---- the main path, once, with the launch counts from zero ----
    count_reset()
    with torch.inference_mode():
        images = normalize(center_crop(raw, vcfg.image_size), 3)
        out = model(images)
        codes = out["codes"]
        gallery[planted] = ts.strict_signs(codes)
        packed, n_pad = ts.pack_serving_gallery(gallery)
        flat = packed.reshape(n_pad, nbit)
        bits = ts.pack_bits_serving(packed, nbit)
        d, idx = retrieve_topk(codes, flat, k=k, exact=True, n_valid=N)
        d_s, i_s = retrieve_topk_streaming(codes, packed, k=k,
                                           db_block=n_pad, exact=True,
                                           n_valid=N, db_bits=bits)
        d_p, i_p = retrieve_topk_streaming(codes, flat, k=k,
                                           db_block=n_pad, exact=True,
                                           n_valid=N, db_bits=bits)
    torch.cuda.synchronize()
    n_layer, n_mins, n_mins_plain = counts()[:3]
    print(f"main path launches: encoder_layer {n_layer} (12 per encode "
          f"expected: {vcfg.num_layers}), subblock_mins {n_mins} over the "
          f"packed layout and {n_mins_plain} over the plain one")
    if n_layer != vcfg.num_layers or n_mins < 1 or n_mins_plain < 1:
        fail("a kernel of the main path was not launched as expected")

    # ---- what came out ----
    B = sizes.images
    if codes.shape != (B, nbit) or not torch.isfinite(codes).all():
        fail(f"codes {tuple(codes.shape)} not finite of shape {(B, nbit)}")
    for key, shape in (("logits_cont", (B, model.cfg.nclass)),
                       ("logits_bin", (B, model.cfg.nclass)),
                       ("logits_concept", (model.cfg.ncontext, B,
                                           model.cfg.nclass))):
        if out[key].shape != shape or not torch.isfinite(out[key]).all():
            fail(f"{key} not finite of shape {shape}")
    hit = ((idx == planted[:, None]) & (d == 0)).any(dim=1)
    print(f"planted rows found at distance 0: {int(hit.sum())}/{B}")
    if not hit.all():
        fail("a planted gallery row did not come back at distance 0")
    with torch.inference_mode():
        dist = sign_distances(codes, gallery)
        pd, _ = exact_topk_blocked(dist, k)
        same_d = all(torch.equal(x, pd) for x in (d, d_s, d_p))
        consistent = all(torch.equal(dist.gather(1, i), x)
                         for i, x in ((idx, d), (i_s, d_s), (i_p, d_p)))
        with plain_layers():
            codes_plain = model(images)["codes"]
    agree = ((codes > 0) == (codes_plain > 0)).float().mean().item()
    print(f"top-{k} distances equal the plain full-matrix top-k: {same_d}; "
          f"indices score their distances: {consistent}")
    print(f"codes vs plain encode: sign agreement {agree:.6f}, max |d| "
          f"{(codes - codes_plain).abs().max().item():.4g}")
    if not (same_d and consistent):
        fail("exact top-k differs from the plain full-matrix top-k")
    if agree < MIN_SIGN_AGREEMENT:
        fail(f"codes agree in sign on {agree:.4f} < {MIN_SIGN_AGREEMENT}")
    del dist, pd, codes_plain
    check_f32_encode(sizes, images, codes, device)

    # ---- timings on the card ----
    def serve():
        return retrieve_topk(codes, flat, k=k, exact=True, n_valid=N)

    def serve_packed_once():
        return retrieve_topk_streaming(codes, packed, k=k, db_block=n_pad,
                                       exact=True, n_valid=N, db_bits=bits)

    with torch.inference_mode():
        enc_s = host_s(lambda: model(images), 3)
        srv_s = host_s(serve, 5)
        once_s = host_s(serve_packed_once, 5)
    print(f"encode: {B / enc_s:.1f} img/s ({B} images, bf16, "
          f"{enc_s * 1e3:.2f} ms per batch)")
    print(f"serving: {B / srv_s:.1f} queries/s (retrieve_topk exact, "
          f"k={k}, {B} queries over {N} codes, {srv_s * 1e3:.2f} ms; it "
          f"packs the gallery on every call)")
    print(f"serving, gallery packed once: {B / once_s:.1f} queries/s "
          f"(retrieve_topk_streaming exact with db_bits, k={k}, "
          f"{once_s * 1e3:.2f} ms)")

    layers = model.backbone.layers
    L = images.shape[1] // vcfg.patch_size
    L = L * L + 1 + model.cfg.ncontext
    ws = [lay.layer_weights(torch.bfloat16) for lay in layers]
    ads = [(lay.adapter_attn.weights(torch.bfloat16),
            lay.adapter_mlp.weights(torch.bfloat16)) for lay in layers]
    lib_w = [fl.LayerWeights(*(t.to(torch.bfloat16) for t in w)) for w in ws]
    lib_a = [tuple(fl.AdapterWeights(*(t.to(torch.bfloat16) for t in a))
                   for a in pair) for pair in ads]
    x0 = torch.randn(B, L, vcfg.hidden_size, generator=gen,
                     device=device).to(torch.bfloat16)
    kw = dict(num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
              act=vcfg.hidden_act)

    def through_layers(fn, weights, adapters, **extra):
        def go():
            x = x0
            for w, (a1, a2) in zip(weights, adapters):
                x = fn(x, w, adapter_attn=a1, adapter_mlp=a2, **extra)
            return x
        return go

    n_l = len(layers)
    with torch.inference_mode():
        layer_ms = cuda_ms(through_layers(fl.encoder_layer_cuda, ws, ads,
                                          **kw), sizes.reps) / n_l
        layer_plain_ms = cuda_ms(through_layers(fl.layer_reference, ws, ads,
                                                **kw), 3) / n_l
        layer_lib_ms = cuda_ms(through_layers(
            lambda x, w, adapter_attn, adapter_mlp: layer_library(
                x, w, adapter_attn, adapter_mlp, vcfg.num_heads,
                vcfg.layer_norm_eps), lib_w, lib_a), sizes.reps) / n_l
        layer_host_us = host_us(through_layers(fl.encoder_layer_cuda, ws,
                                               ads, **kw), sizes.reps) / n_l
    flops, nbytes = layer_flops_bytes(B, L, vcfg.hidden_size,
                                      vcfg.intermediate_size,
                                      sizes.bottleneck, 2, ws[0], ads[0])
    layer_bound = max(flops / BF16_PEAK, nbytes / HBM_RATE) * 1e3
    layer_by = "operations" if flops / BF16_PEAK >= nbytes / HBM_RATE \
        else "bytes"

    qi = ts.strict_signs(codes)
    m = -(-n_pad // 64)
    bp_gallery, _ = ts.pack_bitplane_serving(flat)
    with torch.inference_mode():
        # as exact_topk_minspass calls it at this m (the direct selection,
        # no superblock mins)
        mins_ms = cuda_ms(lambda: ts.subblock_mins_cuda(
            qi, packed, n_pad, 64, m, torch.bfloat16), sizes.reps)
        mins_sb_ms = cuda_ms(lambda: ts.subblock_mins_cuda(
            qi, packed, n_pad, 64, m, torch.bfloat16, superblocks=True),
            sizes.reps)
        mins_plain_ms = cuda_ms(lambda: ts._mins_reference_serving(
            qi, flat, 64, m, torch.bfloat16), 3)
        mins_lib_ms = cuda_ms(lambda: (0.5 * (nbit - torch._int_mm(
            flat, qi.t()).view(m, 64, B).amax(dim=1))).to(torch.bfloat16),
            sizes.reps)
        plain_layout_ms = cuda_ms(lambda: ts.subblock_min_dists(
            qi, flat, 64, torch.bfloat16), sizes.reps)
        bp_same_ms = cuda_ms(lambda: ts.subblock_mins_bitplane_cuda(
            qi, bp_gallery, bp_gallery.shape[0] * 8, 64, m, torch.bfloat16),
            sizes.reps)
    del bp_gallery
    mins_bytes = n_pad * nbit + B * nbit + m * B * 2
    mins_ops = 2 * B * n_pad * nbit
    mins_bound = max(mins_bytes / HBM_RATE, mins_ops / INT8_PEAK) * 1e3
    mins_by = "bytes" if mins_bytes / HBM_RATE >= mins_ops / INT8_PEAK \
        else "operations"

    print(f"encoder_layer (B={B}, L={L}, both adapters, per layer): kernel "
          f"{layer_ms:.4f} ms, bound {layer_bound:.4f} ms ({layer_by}: "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain "
          f"{layer_plain_ms:.4f} ms, library (F.linear + SDPA) "
          f"{layer_lib_ms:.4f} ms; {flops / layer_ms / 1e9:.1f} TFLOP/s; "
          f"host {layer_host_us:.1f} us per call")
    print(f"subblock_mins (Q={B}, N={n_pad}, nbit={nbit}, S=64, packed, "
          f"bf16): kernel {mins_ms:.4f} ms ({mins_sb_ms:.4f} with the "
          f"superblock mins), bound {mins_bound:.4f} ms ({mins_by}: "
          f"{mins_bytes / 1e6:.1f} MB, {mins_ops / 1e9:.1f} G int8 ops), "
          f"plain {mins_plain_ms:.4f} ms, library (torch._int_mm + amax) "
          f"{mins_lib_ms:.4f} ms; kernel 4 (bitplane_mins) over the same "
          f"codes as bit-planes {bp_same_ms:.4f} ms")
    print(f"subblock_mins, plain (N, {nbit}) layout (Q={B}, N={n_pad}, "
          f"bf16, through subblock_min_dists): kernel {plain_layout_ms:.4f} "
          f"ms, bound {mins_bound:.4f} ms ({mins_by}), plain "
          f"{mins_plain_ms:.4f} ms, library {mins_lib_ms:.4f} ms (the same "
          f"bytes as the packed layout)")

    with torch.inference_mode():
        layer_split(device_breakdown("encode", lambda: model(images), enc_s),
                    vcfg.num_layers)
        device_breakdown("serving (retrieve_topk)", serve, srv_s, op_rows=10)
        device_breakdown("serving, gallery packed once "
                         "(retrieve_topk_streaming)", serve_packed_once,
                         once_s, op_rows=10)
    nclass = model.cfg.nclass
    del images, raw, model
    torch.cuda.empty_cache()

    tr = run_train(sizes, device)
    bp_err = check_bitplane_mins(sizes, device)
    bp = run_bitplane(sizes, device, codes, nbit)
    run_approx(sizes, codes, gallery, packed, bits, n_pad)
    run_scoring(sizes, codes, nclass, device)
    del gallery, packed, bits
    torch.cuda.empty_cache()
    run_text_tower(sizes, device)
    flagship = run_flagship(sizes, device)
    run_variants(sizes, device)
    run_baselines(sizes, device)
    run_finegrained(sizes, device)
    run_unsupervised(sizes, device)
    run_pretrain(sizes, device)
    run_trunks(sizes, device)
    run_graphs(sizes, device, flagship)
    return {"kernels": [
        {"name": "encoder_layer", "route": "cuda",
         "source": "concepthash_tpu_torch/csrc/fused_layer.cu",
         "replaces": "concepthash_tpu/ops/fused_layer.py:156",
         "launches": n_layer, "max_abs_err": layer_err, "ms": layer_ms,
         "plain_ms": layer_plain_ms, "bound_ms": layer_bound,
         "bound_by": layer_by, "library_ms": layer_lib_ms},
        {"name": "subblock_mins", "route": "cuda",
         "source": "concepthash_tpu_torch/csrc/topk_select.cu",
         "replaces": "concepthash_tpu/ops/topk_select.py:86",
         "launches": n_mins, "max_abs_err": mins_err, "ms": mins_ms,
         "plain_ms": mins_plain_ms, "bound_ms": mins_bound,
         "bound_by": mins_by, "library_ms": mins_lib_ms},
        {"name": "subblock_mins_plain_layout", "route": "cuda",
         "source": "concepthash_tpu_torch/csrc/topk_select.cu",
         "replaces": "concepthash_tpu/ops/topk_select.py:210",
         "launches": n_mins_plain, "max_abs_err": mins_plain_err,
         "ms": plain_layout_ms, "plain_ms": mins_plain_ms,
         "bound_ms": mins_bound, "bound_by": mins_by,
         "library_ms": mins_lib_ms},
        *({"name": name, "route": "cuda",
           "source": f"concepthash_tpu_torch/csrc/{src}.cu",
           "replaces": replaces, "launches": tr[name]["launches"],
           "max_abs_err": err, "ms": tr[name]["ms"],
           "plain_ms": tr[name]["plain_ms"], "bound_ms": tr[name]["bound_ms"],
           "bound_by": tr[name]["bound_by"],
           "library_ms": tr[name]["library_ms"]}
          for name, src, replaces, err in (
              ("ln_matmul", "fused_ln", "concepthash_tpu/ops/fused_ln.py:41",
               ln_err),
              ("attention", "attention", "concepthash_tpu/ops/attention.py:35",
               attn_err))),
        {"name": "bitplane_mins", "route": "cuda",
         "source": "concepthash_tpu_torch/csrc/bitplane_mins.cu",
         "replaces": "concepthash_tpu/ops/topk_select.py:765",
         "launches": bp["launches"],
         "max_abs_err": max(bp_err, bp["max_abs_err"]), "ms": bp["ms"],
         "plain_ms": bp["plain_ms"], "bound_ms": bp["bound_ms"],
         "bound_by": bp["bound_by"], "library_ms": bp["library_ms"]},
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    import concepthash_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    result = run(Sizes(), torch.device("cuda"))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
