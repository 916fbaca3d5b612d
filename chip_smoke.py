#!/usr/bin/env python3
"""Drive the PyTorch port (pww_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py [--steps N] [--kernels-only | --e2e-reps R]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device: the card's name and power limit, TF32 switched off for the f32
   reference products;
2. build: nvcc compiles every kernel from pww_tpu_torch/csrc (K1-K5);
2a. jax random: the host threefry (``pww_tpu_torch/utils/jax_random.py``,
   the JAX package's ``jax.random`` numbers, which ``noise_mode="jax"``,
   the default, draws) against JAX_KNOWN_ANSWERS, and the host ms of one
   SDXL latent, a batch-8 512² latent and one batch-8 ancestral step's
   noise;
3. kernels: K1 pww_reduce, K2 pww_cross_attention and K3
   flash_self_attention against their plain PyTorch versions at every shape
   of SD-1.5's 512² main path, bf16 inputs from a seeded generator, with
   CUDA-event timings of the kernel, the plain version, a one-call library
   yardstick where one exists, and the least time the card could take (K1
   in every mode, std also at |mean| ≫ std, each case called twice and
   required bit-identical, with its launch plan printed); then K3 at dh 64
   and 160 and ragged L, K1 in every mode and K2 at ragged Lq and at two and
   four prompt chunks (Lk 154, 308), K1-K3 at the serving path's batch-8
   shapes (CFG rows B 16, B·H 128), K3 at ToMe's merged L 2048 and K1-K3
   at the hires fix's 1024² second pass (Lq 16384, dh 40; K3's plain
   version on two of the 16 (sample, head) pairs), K1-K3 at SD-2.1
   768-v's head-dim-64 shapes (SD21_SHAPES), K3 at Lq ≠ Lk (a rank's rows
   at dp 2: SD-1.5 512², SDXL and the refiner at 1024², the hires fix's
   Lq 8192 / Lk 16384, its plain version on two pairs) and K1, K2 at the
   hires fix's Lq 8192; then K4 group_norm and K5
   layer_norm at
   every site signature of the inpaint path (the tables K4_SITES and
   K5_SITES) and of SDXL-inpainting at 1024² (XL_K4_SITES, XL_K5_SITES;
   spans up to (1, 256, 1024, 1024), 8 M elements a group, streamed),
   with ``F.group_norm`` and ``F.layer_norm`` as the library yardstick
   where no pre-add or SiLU, K4 off the path at a scalar span (1, 64, 33,
   33), K4's plan per case, and each kernel's loss_ms_per_run (Σ calls
   per 30-step SD-1.5 inpaint run × (ms − bound)); then K4 and K5 at every
   signature of the served path (SERVE_K4_SITES, SERVE_K5_SITES: 16 CFG
   rows in the UNet, a decode of 8 images), each timed beside the f32
   composition the sites ran before the norm-site rule, and the device ms
   of a 30-step group of 8 in each form; ``--kernels-only``
   stops after this phase, and
   ``--e2e-reps R`` runs phase 5's call R times in its place, then R turns
   of it without and with a ControlNet, the host time inside the UNet's and
   the ControlNet's forward and the synchronising operations of one
   ControlNet call, and the host time of each K2 and K3 wrapper call;
3a. train kernels (not with ``--kernels-only``): K3 under autograd at the
   training shapes (batch 1, no CFG: L 4096 dh 40 and L 1024 dh 80, B·H
   8), its Function's dQ, dK, dV against autograd through the plain version
   on the same bf16 inputs, with CUDA-event times of the forward kernel,
   the plain backward, and SDPA's forward and backward as a yardstick;
4. reference: a reduced-depth SD-1.5-width txt2img (256 px, 3 steps) on the
   card in bf16 against the same pipeline on the CPU in f32;
5. main path: SD-1.5 at full width (synthetic N(0, 0.02) weights) through
   ``paint_with_words``, 512², cat/dog color map, CFG 7.5, LMS; the kernel
   launch counters are zeroed before the run and must read K1 = K2 = 15·N,
   K3 = 10·N, K4 = 61·N + 30 and K5 = 48·N after it (the norm knobs are
   off, and every norm site takes its kernel on bf16 inputs on the card:
   SD15_NORMS, ``path_launches``);
6. profile: device time by kernel group over a 5-step call (torch.profiler),
   the device's idle share, and each kernel's device time and device
   kernels per wrapper call, which must be 1 for K1 and K4;
7. img2img: one full-width ``paint_with_words`` call with an init image at
   strength 0.5 on the same pipeline (N/2 steps, counts checked);
7a. utils: the native host library (``pww_tpu_torch/native``, built with
   g++) on phase 5's color map, equal to its numpy versions; ``PhaseTimer``
   on the card; ``trace`` writing a Chrome trace of a 2-step call that
   holds K1-K3's device kernels; ``enable_nan_checks`` catching a NaN
   planted before the UNet's ``conv_in``; ``lpips_distance`` (random
   weights) on the card against the CPU within 1e-4 relative;
7b. mesh: ``PwwPipeline(mesh=make_mesh(dp, tp))`` at SD-1.5 width
   (synthetic weights from phase 5's seed), 512², MESH_STEPS LMS steps,
   MESH_SAMPLES samples, on two ranks that share the card over gloo
   (``parallel.mesh.spawn``), at dp 2 and at tp 2: both ranks' images and
   latents bit-equal, each within MESH_TOL relative L2 of phase 5's
   pipeline's call alone; per rank K1 = K2 = 15, K3 = 10, K4 = 61 and K5
   = 48 launches a visit (K4 30 more a decode), K1 at B·H 16, and at tp 2
   three sums a transformer block (48)
   and one reduce a PwW cross-attention (16) a visit; at tp 2 the first K1
   site's r, combined, within MESH_R_TOL of the one-process r, and some
   rank's own r outside it (the control); ms/step printed as
   gloo with two ranks on one card (no scaling number). On the same ranks:
   spatial dp-2 txt2img and inpaint, dp-2 serving and tp-2 training
   (:func:`check_spatial_serve_train`), then SPATIAL_MODES at full width
   and 1 sample, each against the same call in one process
   (:func:`spatial_modes`, :func:`check_spatial_modes`): LCM 4 steps, the
   T2I-Adapter, the IP-Adapter plus with its ViT-H/14 tower, the hires fix
   512² → 1024², SDXL base + refiner at 1024² (base to 0.8); latents and
   images within SPATIAL_TOL, the ranks bit-equal, launches and
   collectives as derived from the configs. Then one NCCL group at world
   size 1 (``init_multihost``), bit-equal to the call without a mesh;
8. serve: on phase 5's pipeline with no per-phase syncs, a
   ``Batcher(max_batch=8)`` takes 16 concurrent txt2img requests from 16
   threads (distinct prompts, seeds and color maps on one 512² grid), N
   LMS steps, CFG 7.5: two ``generate_batch`` calls (two groups of 8),
   each with K1 = K2 = 15·N, K3 = 10·N, K4 = 61·N + 30 (SERVE_K4_SITES)
   and K5 = 48·N (SERVE_K5_SITES), the second launched while the
   first group's fetch is held back; 16 finite and pairwise distinct
   images; the first and last request of each group take the denoise
   inputs (initial latents, text states, PwW weights) of the same request
   through ``generate`` alone bit for bit, and their images lie within
   ``SERVE_IMAGE_TOL`` relative L2 of its image; a planted row-order
   fault (the PwW weights rolled by one request) must break the inputs'
   equality; s/image, peak GiB, one synchronised group's
   ms/step; a 5-step profile of 8 requests (K1 one device kernel per
   call); one ``generate`` with a two-window long prompt (K1 and K2 at Lk
   154, 15·N each); one ``POST /generate`` to the server's handler on a
   localhost server, whose PNG must equal ``generate``'s;
8a. extras reference: each sampling extra on phase 4's reduced-depth
   config, card bf16 against CPU f32 (``EXTRAS_REF_TOL``): DeepCache 2,
   FreeU, prompt editing, SAG (with the mask keys that differ at the first
   visit), the hires fix 256 → 512 px, ToMe 0.5 at 512 px (with the
   tokens merged on one device only at the first site), and LCM 4-step on
   a UNet with a 256-wide ``cond_proj``;
8b. extras: on phase 5's pipeline, the same map, prompt and seed, N steps
   each: plain, DeepCache ``cache_interval=5`` (full visits K1/K2/K3
   15/15/10, shallow 5/5/5), ToMe 0.5 (K3 at L 2048 at the 64² sites,
   counted by length), FreeU, SAG 0.75 (30/30/20 a visit), LCM 4 steps on
   a copy of the UNet with LCM-Dreamshaper-v7's ``time_cond_proj_dim``
   256, prompt editing ``[cat:fox:0.5]`` (two prompts encoded), and
   ``generate_hires`` 512² → 1024² at strength 0.7 (16/16/15 a 1024²
   visit; K4 and K5 61 and 48 a full visit, 16 and 15 a shallow one, K4 30
   a decode); each gated on finite final latents that differ from the plain
   run's and on its launches, with s/image, ms/visit and peak GiB; then
   5-step profiles of DeepCache and ToMe;
8f. train (after extras, on phase 5's pipeline): ``train_textual_inversion``
   and ``train_lora`` (rank 8, the attention linears), 3 steps each on two
   512² synthetic images; finite losses, TI's old table rows bit-equal and
   its new row moved, every LoRA B nonzero and every A moved after step 3,
   the UNet bit-equal after ``train_lora``, K3 = 10 launches a train step,
   K1 = K2 = 0, and K4 and K5 only at the sites ahead of the first tensor
   that requires a gradient and in the images' encodes
   (TRAIN_NORMS_PER_STEP); K1, K2, K4 and K5 raise under grad mode on the
   card, and the norm sites keep the f32 composition, bit for bit and with
   no launch, on a bf16 input under autograd and on an f32 input; N steps
   with the trained placeholder and with the saved LoRA
   loaded (15/15/10 a visit, finite latents, the LoRA image unlike the
   plain one); ms per train step, peak GiB and a 1-step profile of each
   trainer (K3's device ms inside a step);
8g. graphs (after adapters, on pipelines of its own): the denoise loop's
   UNet visits replayed from CUDA graphs (``pipeline/graphs.py``) against
   the eager loop, at SD-1.5 16 CFG rows 512² and SDXL-base 8 rows 1024²:
   four groups of GRAPH_STEPS steps each, a LoRA merged for the second and
   restored after it; the UNet's outputs visit by visit and the uint8
   images identical, or within the cell's ``image_rel_l2`` limit; K1-K5 of
   the table on both paths; each capture's ms and reserved GB, and each
   path's peak memory; a profile of a replayed group (K1-K4 one device
   kernel a wrapper call); the hires fix and LCM-4 at batch 1 against the
   eager loop, with wall ms of a first (capturing) call, a second, and two
   eager ones. Alone: ``python3 -c "import chip_smoke as c;
   smi = c.phase_device(); c.phase_build(); c.phase_graphs(smi)"``;
8c. single file: SD-1.5 at full width written as an A1111/LDM single
   ``.safetensors`` file (fp16, I64 ``position_ids``, ``ldm_state_dict``)
   with the tokenizer's files beside it, loaded through ``pww_load_tools``
   (the detected config must be ``SDModelConfig.sd15()``, every tensor the
   written fp16 value in bf16); a two-vector A1111 ``.pt`` and a one-vector
   diffusers ``.safetensors`` embedding applied (their rows bit-equal, the
   placeholders bound by the PwW weights); N LMS steps at 512² with
   ``latents=`` in NHWC (K1 = K2 = 15·N, K3 = 10·N), its image within 1e-3
   relative L2 of ``seed=``'s, a 5-step profile; a depth-cut SD-1.5
   (``depth_cut_sd15``) single file with an embedding, card bf16 against
   CPU f32 (< 5e-2); ``save_pretrained`` → ``from_pretrained`` (weights
   bit-equal, the recorded scheduler back, the N-step image within 1e-3);
   ``apps.runner.main`` on the file (15·N / 15·N / 10·N); ``run_pww``,
   ``run_pww_inpaint`` and ``apps.runner_inpaint`` on the depth-cut model;
   LDM-BERT at its published size, card bf16 against CPU f32 (< 5e-2).
   Every file is deleted;
9. norm sites: a 1-step warm-up of phase 11's pipeline records every K4
   and K5 call's signature, which must be the tables of phase 3;
10. inpaint reference: a reduced-depth 9-channel inpaint with the norm
    knobs on, card bf16 against CPU f32;
11. inpaint path: SD-1.5-inpainting at full width (9-channel ``conv_in``,
    synthetic weights, ``fused_group_norm`` and ``fused_layer_norm`` on in
    the UNet and the VAE) through ``paint_with_words_inpaint``, 512², N
    steps at strength 1.0; the counters must read K4 = 61·N + 2·22 + 30,
    K5 = 48·N, K1 = K2 = 15·N, K3 = 10·N; then its own 5-step profile, in
    which K1 and K4 must be one device kernel per call;
12. tiny: ``SDModelConfig.tiny()`` on the card (head dims 8 and 16, which
    K1-K3 are not built for), 128 px, 2 steps: no K1-K3 launches, K4
    and K5 at every norm site (TINY_NORMS);
13. sd2 reference: a reduced-depth SD-2.1-width txt2img (head dim 64,
    v-prediction), 256 px, 3 steps, card bf16 against CPU f32, with the LMS
    and the DDIM scheduler; K1-K3 must launch;
14. sd21 path: a full-width synthetic SD-2.1 768-v diffusers directory
    (fp16 safetensors, written to a temporary directory and deleted at the
    end) loaded through ``paint_with_words(local_model_path=...)``, 768², N
    LMS steps, counts K1 = K2 = 15·N, K3 = 10·N, K4 = 61·N + 30, K5 = 48·N,
    the loader's cache checked; its 5-step profile (K1 one device kernel
    per call);
15. schedulers: one 4-step call per scheduler kind and DPM++ 2M Karras on
    that pipeline, K1 = K2 = 15 and K3 = 10 launches per visit;
16. controlnet reference: phase 4's reduced-depth config with one ControlNet
    and one T2I-Adapter of that config (synthetic weights, zero convs
    included), hints drawn from the color map's edges, card bf16 against
    CPU f32;
17. controlnet path: SD-1.5 at full width plus a full SD-1.5 ControlNet
    written as a diffusers directory (deleted at the end) and attached by
    ``load_controlnet(source=...)``, 512², N LMS steps, CFG 7.5, the color
    map's edges as the hint; counts K1 = K2 = 21·N, K3 = 14·N, K4 = (61 +
    27)·N + 30, K5 = (48 + 21)·N, the image unlike the one without the
    hint, a 5-step profile; then 4-step
    calls with two stacked ControlNets (27/27/18 per visit), the T2I-Adapter
    at full width (15/15/10 per visit, unlike the run without it) and a
    custom weight function with one ControlNet (the split path: 0/0/28);
18. sdxl reference: SDXL base and refiner at their published widths, cut in
    depth (layers_per_block 1, transformer depth 2, 2-layer towers), 512²,
    3 LMS steps, card bf16 against CPU f32 (K1/K2/K3 14/14/6 a visit); then
    6 steps cut at 0.5: the base to denoising_end, the refiner from there
    (12/12/6), and the refiner's update from the CPU's base latents;
8d. adapters reference: phase 4's reduced-depth config with a kohya LoRA
   (rank 8, every UNet and text linear, proj and resnet conv) merged and
   each IP-Adapter variant attached (a ViT-H/14 image tower at its widths,
   cut to 2 layers), 256 px, 3 steps, card bf16 against CPU f32 (< 5e-2);
   the ViT-H/14 tower at its published size (6.3e8 parameters) on one
   reference image, embeddings and penultimate states (< 5e-2);
8e. adapters: on phase 5's pipeline, N LMS steps at 512² with the map:
   a kohya LoRA file (rank 64, alpha 32: every attention and feed-forward
   linear, the 1×1 proj convs, LoCon 3×3 entries on every resnet conv,
   every text linear; fp16) written and loaded (its module count, size,
   write and load s), K1/K2/K3 15/15/10 a visit, an image unlike the
   plain one; the same entries in the peft layout merge bit-equal; after
   ``unload_loras`` every UNet and CLIP tensor is bit-equal to before; a
   ViT-H/14 image encoder written as a transformers directory and the
   ``ip-adapter_sd15``- and ``ip-adapter-plus_sd15``-shaped files, each
   attached by ``load_ip_adapter`` and run with a reference image (15/15/10
   a visit, the encoder's ms per image; ``ip_adapter_scale=0.0`` gives
   the plain image bit for bit, scale 1 another); for the standard file
   one request through the ``Batcher`` and one ``POST /generate``
   (``ip_adapter_image_png_b64``), both bit-equal to ``generate``, a 4-row
   ``generate_batch`` sharing the image (each row within
   ``SERVE_IMAGE_TOL`` of the request alone), and a 5-step profile;
19. sdxl path: SDXL-base at diffusers' published shapes written as an fp16
    diffusers directory (the free space printed first; deleted once
    loaded), through ``paint_with_words(local_model_path=...)``, 1024², N
    LMS steps, CFG 7.5, K1 = K2 = K3 = 70·N (SDXL_LAUNCHES_PER_VISIT), K4
    = 46·N + 30, K5 = 210·N (SDXL_NORMS), a
    5-step profile; the refiner at its published shapes the same way, one
    ensemble call (the base's visits at t >= 200, the refiner's 44/44/40 a
    visit after them), and one 4-step euler call on the base; then on the
    base at 1024², 4 steps each, a kohya LoRA at rank 32 (UNet attention,
    ``lora_te1_``, ``lora_te2_``; 70/70/70 a visit, the unload bit-equal)
    and an ``ip-adapter_sdxl_vit-h``-shaped file with the ViT-H encoder
    (70 sites; 70/70/70 a visit, scale 0 bit-equal to no adapter).
    Before the adapters, on the same base ("sdxl controlnet"): an SDXL
    ControlNet at diffusers' published shapes (SDXL_CONTROLNET_PARAMS,
    ``text_time``) written as an fp16 diffusers directory, attached by
    ``load_controlnet(source=...)``, 4 LMS steps at 1024² with the map's
    edges as the hint: K1 = K2 = K3 = (70 + 34)·4, the image unlike the
    plain one, s/image, peak GiB, a 3-step profile;
18a. sdxl controlnet reference (before 19): 18's reduced base with an
    SDXL ControlNet of that config, 512², 3 LMS steps, card bf16 against
    CPU f32 on the batched (20/20/8 a visit) and the split path (0/0/16);
20. sdxl inpaint reference: 18's reduced base as a 9-channel UNet with
    the norm knobs on, 512², 3 steps at strength 1.0, card against CPU;
21. sdxl inpaint: SDXL-inpainting at published shapes (9-channel
    ``conv_in``, synthetic weights, the norm knobs on) through
    ``paint_with_words_inpaint``, 1024², 4 LMS steps: one step's K4/K5
    signatures against XL_K4_SITES / XL_K5_SITES, then K1 = K2 = K3 =
    70·4, K4 = 46·4 + 2·22 + 30, K5 = 210·4, s/image, peak GiB and a
    2-step profile (K1 and K4 one device kernel per call).

Then a JSON line with every kernel, the card's name and power limit, and
last {"ok": true, "device": {...}}.
Imports nothing of JAX. Needs one card.
"""
import argparse
import atexit
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores (the norms)
# SD-1.5 at 512²: the (Lq, head dim) of the attention sites, five of each per
# UNet call (self-attention takes K3 at the first two, cross-attention K1+K2
# at all three)
SHAPES = ((4096, 40), (1024, 80), (256, 160))
# SD-2.1 768-v at 768²: (Lq, heads) of the attention sites, head dim 64, five
# of each per UNet call (K3 at the first two; the 144-token mid block and the
# L 576 self-attention stay dense)
SD21_SHAPES = ((9216, 5), (2304, 10), (576, 20))
STEPS_PER_RUN = 30  # the operating point's LMS steps, for calls per run
# SDXL at 1024² (latent 128², CFG batch 2): (heads, Lq, head dim) of the
# cross-attention sites → K1 and K2 calls per UNet visit; K3 takes the
# self-attention sites of L >= 1024 (tests/test_torch_sdxl.py traces both
# UNets on the meta device against these tables)
SDXL_SITES = {
    "sdxl": {(10, 4096, 64): 10, (20, 1024, 64): 60},
    "sdxl_refiner": {(12, 4096, 64): 20, (24, 1024, 64): 20, (24, 256, 64): 4},
}
SDXL_LAUNCHES_PER_VISIT = {"sdxl": (70, 70, 70), "sdxl_refiner": (44, 44, 40)}
# diffusers' parameter counts of the two models' parts
SDXL_PARAMS = {
    "sdxl": {"unet": 2_567_463_684, "clip": 123_060_480, "clip2": 694_659_840,
             "vae": 83_653_863},
    "sdxl_refiner": {"unet": 2_259_526_660, "clip": 694_659_840, "vae": 83_653_863},
}
# SDXL's ControlNet at diffusers' published shapes (the base's encoder copy
# with its own text_time add_embedding) adds to a 1024² visit its down
# blocks' 4 sites at Lq 4096 and 20 at Lq 1024 and the mid block's 10
# (tests/test_torch_sdxl.py traces it on the meta device against these)
SDXL_CONTROLNET_SITES = {(10, 4096, 64): 4, (20, 1024, 64): 30}
SDXL_CONTROLNET_LAUNCHES_PER_VISIT = (34, 34, 34)
SDXL_CONTROLNET_PARAMS = 1_251_014_160
# xl_reduced_configs' base at 512² per visit (its 32² stage: Lq 1024, K1-K3;
# its 16² stage: Lq 256, K1 and K2) and what its ControlNet adds there
XL_REDUCED_VISIT = {"base": (14, 14, 6), "controlnet": (6, 6, 2)}
# The known answers of jax.random for PRNGKey(0) (jax 0.9.0 on the CPU,
# jax_threefry_partitionable on), which the port draws on the host
JAX_KNOWN_ANSWERS = {
    "normal": [1.622642159461975, 2.0252647399902344, -0.4335944354534149,
               -0.07861734926700592],
    "bits": [4070199207, 4202968722, 1427181096, 2012915765],
    "split": [[1797259609, 2579123966], [928981903, 3453687069]],
    "fold_in": [2716826189, 292468403],
    "randint": [789, 0, 712, 373],
    "bf16_normal": [0.38671875, 0.1826171875, -1.0, -0.82421875],
}
# The inpaint path's GroupNorm sites at 512² (SD-1.5-inpainting, CFG batch 2
# in the UNet): (shape, groups, eps, SiLU, pre-add) → calls per UNet step,
# per VAE encode, per VAE decode. An inpaint call at strength 1.0 runs N
# UNet steps, two encodes (image, masked image) and a decode: K4 = 61·N +
# 2·22 + 30.
K4_SITES = {
    ((2, 320, 64, 64), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 320, 64, 64), 32, 1e-05, True, False): (3, 0, 0),
    ((2, 320, 64, 64), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 320, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 640, 64, 64), 32, 1e-05, True, False): (2, 0, 0),
    ((2, 640, 32, 32), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 640, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 640, 32, 32), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 640, 16, 16), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 960, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 960, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 16, 16), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 1280, 16, 16), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 16, 16), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 1280, 8, 8), 32, 1e-06, False, False): (1, 0, 0),
    ((2, 1280, 8, 8), 32, 1e-05, True, False): (4, 0, 0),
    ((2, 1280, 8, 8), 32, 1e-05, True, True): (7, 0, 0),
    ((2, 1920, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1920, 16, 16), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 2560, 16, 16), 32, 1e-05, True, False): (2, 0, 0),
    ((2, 2560, 8, 8), 32, 1e-05, True, False): (3, 0, 0),
    ((1, 256, 512, 512), 32, 1e-06, True, False): (0, 0, 1),
    ((1, 128, 512, 512), 32, 1e-06, True, False): (0, 4, 6),
    ((1, 512, 256, 256), 32, 1e-06, True, False): (0, 0, 1),
    ((1, 256, 256, 256), 32, 1e-06, True, False): (0, 3, 5),
    ((1, 128, 256, 256), 32, 1e-06, True, False): (0, 1, 0),
    ((1, 512, 128, 128), 32, 1e-06, True, False): (0, 3, 6),
    ((1, 256, 128, 128), 32, 1e-06, True, False): (0, 1, 0),
    ((1, 512, 64, 64), 32, 1e-06, True, False): (0, 9, 10),
    ((1, 512, 64, 64), 32, 1e-06, False, False): (0, 1, 1),
}
# The transformer LayerNorms: (shape, eps) → calls per UNet step (48·N).
K5_SITES = {((2, 4096, 320), 1e-05): 15, ((2, 1024, 640), 1e-05): 15,
            ((2, 256, 1280), 1e-05): 15, ((2, 64, 1280), 1e-05): 3}
# The served path's sites at the default config, where every site takes K4
# or K5 on the card: SD-1.5 at 512², a generate_batch of 8 (16 CFG rows in
# the UNet) and its decode of 8 images; K4_SITES' UNet signatures at 16
# rows (calls a visit) and its decoder's at 8 images (calls a decode): K4 =
# 61 a visit + 30 a decode, K5 = 48 a visit
SERVE_ROWS, SERVE_IMAGES = 16, 8
SERVE_K4_SITES = {
    **{((SERVE_ROWS, *k[0][1:]), *k[1:]): (u, 0, 0) for k, (u, _, _) in K4_SITES.items() if u},
    **{((SERVE_IMAGES, *k[0][1:]), *k[1:]): (0, 0, d) for k, (_, _, d) in K4_SITES.items() if d}}
SERVE_K5_SITES = {((SERVE_ROWS, *s[1:]), eps): n for (s, eps), n in K5_SITES.items()}
# The same tables for SDXL-inpainting (a 9-channel SDXL-base UNet, the norm
# knobs on) at 1024²: K4 = 46·N + 2·22 + 30, K5 = 210·N per inpaint call.
XL_K4_SITES = {
    ((2, 320, 128, 128), 32, 1e-05, True, False): (3, 0, 0),
    ((2, 320, 128, 128), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 320, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 640, 128, 128), 32, 1e-05, True, False): (2, 0, 0),
    ((2, 640, 64, 64), 32, 1e-06, False, False): (5, 0, 0),
    ((2, 640, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 640, 64, 64), 32, 1e-05, True, True): (5, 0, 0),
    ((2, 640, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 960, 128, 128), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 960, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1280, 32, 32), 32, 1e-06, False, False): (6, 0, 0),
    ((2, 1280, 32, 32), 32, 1e-05, True, False): (3, 0, 0),
    ((2, 1280, 32, 32), 32, 1e-05, True, True): (7, 0, 0),
    ((2, 1920, 64, 64), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 1920, 32, 32), 32, 1e-05, True, False): (1, 0, 0),
    ((2, 2560, 32, 32), 32, 1e-05, True, False): (2, 0, 0),
    ((1, 128, 1024, 1024), 32, 1e-06, True, False): (0, 4, 6),
    ((1, 128, 512, 512), 32, 1e-06, True, False): (0, 1, 0),
    ((1, 256, 1024, 1024), 32, 1e-06, True, False): (0, 0, 1),
    ((1, 256, 512, 512), 32, 1e-06, True, False): (0, 3, 5),
    ((1, 256, 256, 256), 32, 1e-06, True, False): (0, 1, 0),
    ((1, 512, 512, 512), 32, 1e-06, True, False): (0, 0, 1),
    ((1, 512, 256, 256), 32, 1e-06, True, False): (0, 3, 6),
    ((1, 512, 128, 128), 32, 1e-06, False, False): (0, 1, 1),
    ((1, 512, 128, 128), 32, 1e-06, True, False): (0, 9, 10),
}
XL_K5_SITES = {((2, 4096, 640), 1e-05): 30, ((2, 1024, 1280), 1e-05): 180}
# K4 off the paths: channels that are not a multiple of 8 elements (the
# scalar path); the spans larger than 16 CTAs' shared memory (streamed) are
# SDXL-inpainting's VAE sites at 1024²
K4_OFF_PATH = (((1, 64, 33, 33), 32, 1e-06, False, False),)
# K4's split form at dp 2 (a spatially sharded call): the inpaint path's
# largest UNet site with its pre-add and the VAE's largest, split in two
# halves of rows; their calls per 30-step run at dp 2 (a pair of launches
# each, on each rank)
SPLIT_K4_SITES = {((2, 320, 64, 64), 32, 1e-05, True, True): 5 * STEPS_PER_RUN,
                  ((1, 256, 512, 512), 32, 1e-06, True, False): 1}


def k4_calls(site, unet_steps, encodes=2, decodes=1, table=None):
    u, e, d = (K4_SITES if table is None else table)[site]
    return u * unet_steps + e * encodes + d * decodes


def k4_label(site, mean=0.0):
    """The SD-1.5 inpaint path's sites as "unet"/"vae", SDXL-inpainting's
    others as "xl unet"/"xl vae", the served path's as "serve unet"/"serve
    vae", the rest "off"."""
    (shape, groups, eps, silu, has_add) = site
    part = "unet" if shape[0] in (2, SERVE_ROWS) else "vae"
    where = (part if site in K4_SITES else f"xl {part}" if site in XL_K4_SITES
             else f"serve {part}" if site in SERVE_K4_SITES else "off")
    return (f"{where} {shape}{' add' if has_add else ''}{' silu' if silu else ''} "
            f"eps{eps:g}{f' mean{mean:g}' if mean else ''}")


def k5_label(site, mean=0.0):
    shape, eps = site
    xl = ("xl " if site in XL_K5_SITES and site not in K5_SITES
          else "serve " if site in SERVE_K5_SITES else "")
    return f"{xl}{shape} eps{eps:g}{f' mean{mean:g}' if mean else ''}"

# name → (source, TPU kernel it replaces, launch counter, profile group,
#         the case whose numbers head the kernel's JSON entry)
KERNELS = {
    "pww_reduce": ("pww_tpu_torch/csrc/pww_reduce.cu",
                   "pww_tpu/ops/cross_attention_kernel.py:133", "fused_pww_reduce",
                   "K1 pww_reduce", "Lq4096 dh40 max"),
    "pww_cross_attention": ("pww_tpu_torch/csrc/pww_cross_attention.cu",
                            "pww_tpu/ops/cross_attention_kernel.py:210",
                            "fused_pww_cross_attention", "K2 pww_cross_attention",
                            "Lq4096 dh40"),
    "flash_self_attention": ("pww_tpu_torch/csrc/flash_attention.cu",
                             "pww_tpu/ops/flash_attention.py:64", "flash_self_attention",
                             "K3 flash_self_attention", "L4096 dh40"),
    "group_norm": ("pww_tpu_torch/csrc/group_norm.cu", "pww_tpu/ops/group_norm.py:288",
                   "group_norm", "K4 group_norm",
                   k4_label(((1, 256, 512, 512), 32, 1e-06, True, False))),
    "layer_norm": ("pww_tpu_torch/csrc/layer_norm.cu", "pww_tpu/ops/layer_norm.py:60",
                   "layer_norm", "K5 layer_norm", k5_label(((2, 4096, 320), 1e-05))),
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20, trials=5, warmup=3):
    """Device time of one call: the median over ``trials`` of the mean of
    ``reps`` back-to-back calls between two CUDA events. A spin kernel
    queued first holds the card while the host enqueues the calls, so the
    host's per-call overhead stays out of the reading. The inputs stay in
    the 50 MB L2 between calls, as the main path's freshly written
    activations often are."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device cycles
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


class Cases:
    """Kernel-versus-plain comparisons, by kernel; failures are collected."""

    def __init__(self):
        self.by_kernel = {}
        self.failed = []

    def record(self, kernel, label, got, want, tol, rel_tol, ms, plain_ms, bnd, library_ms,
               flops=None, calls=None):
        """``calls``: the case's calls per 30-step run of its path (None: off
        the path), for the kernel's loss_ms_per_run."""
        import torch

        diff = got.float() - want.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / want.float().norm()).item()
        ok = (bool(torch.isfinite(got.float()).all()) and err <= tol
              and (rel_tol is None or rel <= rel_tol))
        self.by_kernel.setdefault(kernel, []).append(dict(
            case=label, numel=want.numel(), max_abs_err=err, tol=tol, rel_l2_err=rel,
            rel_tol=rel_tol, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=library_ms, tflops=flops / ms * 1e-9 if flops else None,
            calls_per_run=calls))
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        rate = f", {flops / ms * 1e-9:.1f} TFLOP/s" if flops else ""
        log(f"[kernels] {kernel} {label}: max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"rel_l2 {rel:.3e} (tol {rel_tol}) {'ok' if ok else 'FAIL'} | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}){rate}")
        if not ok:
            self.failed.append(f"{kernel} {label}")

    def check(self):
        if self.failed:
            raise SystemExit(f"[kernels] outside tolerance: {self.failed}")


def loss_ms_per_run(cases):
    """Σ over a kernel's path cases of calls per 30-step run × (ms − bound):
    the ranking quantity of the kernel redesigns."""
    return sum(c["calls_per_run"] * (c["ms"] - c["bound_ms"]) for c in cases
               if c.get("calls_per_run"))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from pww_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    reports = cuda_build.build()
    log(f"[build] {len(reports)} of {len(cuda_build.SOURCES)} sources compiled and "
        f"linked in {time.perf_counter() - t0:.1f} s into {cuda_build.library_path()}")
    for name, rep in reports.items():
        entry = None
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = demangle(m.group(1))
            elif "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}")


def demangle(symbol):
    """A kernel's C++ name where c++filt is there, else the symbol."""
    import shutil

    if not shutil.which("c++filt"):
        return symbol
    out = subprocess.run(["c++filt", symbol], capture_output=True, text=True).stdout.strip()
    return re.sub(r"^void |\(.*", "", out.replace("(anonymous namespace)::", "")) or symbol


def phase_kernels():
    """Every K1-K3 case; returns {kernel: [case dicts]}."""
    import torch
    import torch.nn.functional as F

    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.ops.weight_functions import WeightFunction
    from pww_tpu_torch.schedulers.schedules import t_start_from_strength

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, B, H, LK = torch.bfloat16, 2, 8, 77

    def randn(*shape, mean=0.0):
        x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
        return (x + mean).to(bf16)

    cases = Cases()
    record = cases.record

    def xattn_case(q, k, v, label, calls=None):
        """K2 on w with a zero uncond row, coef from the default weight function."""
        B, H, lq, lk, dh = q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]
        w = torch.rand((B, lq, lk), generator=g, device="cuda")
        w[:B // 2] = 0.0  # the uncond rows
        wf = WeightFunction(0.1, "log1p_sigma", "max")
        coef = (wf.sigma_coef(torch.tensor(14.6, device="cuda"))
                * xk.pww_cross_attention_reduce(q, k, wf)).contiguous()
        got = xk.fused_pww_cross_attention(q, k, v, w, coef)
        want = xk.pww_cross_attention_plain(q, k, v, w, coef)
        mask = (coef[:, None, None, None] * w[:, None] * dh ** -0.5).to(bf16)
        # The kernel rounds P to bf16 for the P·V product, as the TPU kernel
        # does (cross_attention_kernel.py:92), and the plain version keeps P
        # in f32: about 2^-9 of each term, a few 1e-3 of the output in
        # relative L2, so 1e-2 there, K3's limit for K3's reason; the max-abs
        # limit is 2-4 bf16 ulps of the largest output. A dropped key chunk
        # or a bias added after the scale moves the relative error by about
        # 1e-1 (estimated, not run).
        record("pww_cross_attention", label, got, want,
               2**-6 * want.float().abs().max().item(), 1e-2,
               time_ms(lambda: xk.fused_pww_cross_attention(q, k, v, w, coef)),
               time_ms(lambda: xk.pww_cross_attention_plain(q, k, v, w, coef)),
               bound((q.numel() * 2 + k.numel() + v.numel()) * 2 + w.numel() * 4 + B * 4,
                     4 * B * H * lq * lk * dh),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
               flops=4 * B * H * lq * lk * dh, calls=calls)

    def flash_case(l, dh, label, calls=None, H=H, B=B, plain_pairs=None, lq=None):
        """``plain_pairs``: the (sample, head) pairs, flat, that the plain
        version checks and is timed on (all by default); ``lq``: fewer
        queries than the ``l`` keys (a spatially sharded site's rows)."""
        lq = l if lq is None else lq
        q, k, v = randn(B, H, lq, dh), randn(B, H, l, dh), randn(B, H, l, dh)
        got = fa.flash_self_attention(q, k, v)
        pq, pk, pv = q, k, v
        if plain_pairs is not None:
            pick = list(plain_pairs)
            pq, pk, pv = (x.reshape(B * H, 1, x.shape[2], dh)[pick] for x in (q, k, v))
            got = got.reshape(B * H, 1, lq, dh)[pick]
        want = fa.self_attention_plain(pq, pk, pv)
        # As K2: P rounded to bf16 for the P·V product, about 2^-9 of each
        # term, 2-3e-3 of the output in relative L2, so 1e-2 there; a wrong
        # scale (dh 48 for 40) or a dropped key tile would move it by about
        # 1e-1 (estimated, not run).
        record("flash_self_attention", label, got, want,
               2**-6 * want.float().abs().max().item(), 1e-2,
               time_ms(lambda: fa.flash_self_attention(q, k, v)),
               time_ms(lambda: fa.self_attention_plain(pq, pk, pv), reps=3),
               bound((2 * q.numel() + 2 * k.numel()) * 2, 4 * B * H * lq * l * dh),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               flops=4 * B * H * lq * l * dh, calls=calls)
        del q, k, v, pq, pk, pv, got, want
        torch.cuda.empty_cache()

    plan_of = getattr(xk, "pww_reduce_plan", None)  # absent in a parent tree

    def reduce_case(qq, kk, mode, label, calls=None):
        """K1 in one mode against its plain version; two calls on the same
        inputs must give bit-identical r."""
        B, H, lq, lk, dh = qq.shape[0], qq.shape[1], qq.shape[2], kk.shape[2], qq.shape[3]
        if plan_of is not None and mode == "max":
            p = plan_of(B, H, lq, lk, dh)
            log(f"[kernels]   K1 plan at Lq{lq} Lk{lk} dh{dh}: {p.warps} warps x {p.tiles} "
                f"Q tiles, {p.key_chunks} key chunks, {p.ctas} CTAs ({p.row_splits} x "
                f"{p.key_splits} per head), {p.smem_bytes} B shared memory per CTA")
        wf = WeightFunction(0.1, "log1p_sigma", mode)
        got = xk.fused_pww_reduce(qq, kk, wf)
        again = xk.fused_pww_reduce(qq, kk, wf)
        want = xk.pww_cross_attention_reduce(qq, kk, wf)
        # f32 sums of exact bf16 products, in another order; a mean near
        # 0 makes a relative measure meaningless, so no L2 limit
        tol = 1e-4 * max(1.0, want.abs().max().item())
        record("pww_reduce", label, got, want, tol, None,
               time_ms(lambda: xk.fused_pww_reduce(qq, kk, wf)),
               time_ms(lambda: xk.pww_cross_attention_reduce(qq, kk, wf)),
               bound((qq.numel() + kk.numel()) * 2 + B * 4, 2 * B * H * lq * lk * dh),
               None, flops=2 * B * H * lq * lk * dh, calls=calls)
        if not torch.equal(got, again):  # the last-CTA fold must not depend on timing
            log(f"[kernels] pww_reduce {label}: two calls differ, {got.tolist()} vs "
                f"{again.tolist()} FAIL")
            cases.failed.append(f"pww_reduce {label} not bit-identical across calls")

    for (lq, dh) in SHAPES:
        q, k, v = randn(B, H, lq, dh), randn(B, H, LK, dh), randn(B, H, LK, dh)
        # K1: every reduce mode, plus |mean| >> std for std
        for mode in ("max", "mean", "std"):
            reduce_case(q, k, mode, f"Lq{lq} dh{dh} {mode}",
                        calls=5 * STEPS_PER_RUN if mode == "max" else None)
        reduce_case(randn(B, H, lq, dh, mean=4.0), randn(B, H, LK, dh, mean=4.0), "std",
                    f"Lq{lq} dh{dh} std large-mean")
        xattn_case(q, k, v, f"Lq{lq} dh{dh}", calls=5 * STEPS_PER_RUN)
        if lq >= 1024:  # K3: self-attention at the flash sites
            flash_case(lq, dh, f"L{lq} dh{dh}", calls=5 * STEPS_PER_RUN)
    # shapes off the 512² path: K3's other head dims, ragged L and Lq, and
    # K2 with two and four prompt chunks (the last past the w rows' room in
    # shared memory at dh 160, where the kernel reads w from device memory)
    flash_case(1024, 64, "L1024 dh64")
    flash_case(1024, 160, "L1024 dh160")
    flash_case(4000, 40, "L4000 dh40")
    # spatial sharding at dp 2 (phase_mesh): each rank's query rows against
    # the whole image's keys at the 512² flash sites, 5 each a visit; and a
    # ragged pair (keys past Lk masked, rows past Lq not stored)
    for lq, l, dh in ((2048, 4096, 40), (512, 1024, 80)):
        flash_case(l, dh, f"dp2 Lq{lq} Lk{l} dh{dh}", lq=lq, calls=5 * STEPS_PER_RUN)
    flash_case(4000, 64, "Lq1000 Lk4000 dh64", lq=1000)
    # the spatial modes at dp 2 (phase_mesh): SDXL base and refiner at 1024²
    # (head dim 64, the K3 sites of SDXL_SITES with half their rows) and the
    # hires fix's 1024² pass (a rank's 8192 rows of the L 16384 sites, K1-K3;
    # plain K3 on two of the 16 (sample, head) pairs, as at L 16384)
    for tag, table in SDXL_SITES.items():
        for (h, lq, dh), _ in table.items():
            if lq >= 1024:
                flash_case(lq, dh, f"dp2 {'xl' if tag == 'sdxl' else 'xlr'} Lq{lq // 2} "
                           f"Lk{lq} H{h} dh{dh}", H=h, lq=lq // 2)
    q, k, v = randn(B, H, 8192, 40), randn(B, H, LK, 40), randn(B, H, LK, 40)
    for mode in ("max", "mean", "std"):
        reduce_case(q, k, mode, f"dp2 hires Lq8192 dh40 {mode}")
    xattn_case(q, k, v, "dp2 hires Lq8192 dh40")
    del q, k, v
    flash_case(16384, 40, "dp2 hires Lq8192 Lk16384 dh40 (plain on pairs 0 and 15)",
               lq=8192, plain_pairs=(0, B * H - 1))
    xattn_case(randn(B, H, 4000, 40), randn(B, H, LK, 40), randn(B, H, LK, 40), "Lq4000 dh40")
    xattn_case(randn(B, H, 4096, 40), randn(B, H, 2 * LK, 40), randn(B, H, 2 * LK, 40),
               "Lq4096 dh40 Lk154")
    xattn_case(randn(B, H, 256, 160), randn(B, H, 4 * LK, 160), randn(B, H, 4 * LK, 160),
               "Lq256 dh160 Lk308")
    # K1 at ragged Lq and with two and four prompt chunks, every mode
    for lq, lk, dh in ((4000, LK, 40), (4096, 2 * LK, 40), (256, 4 * LK, 160)):
        q, k = randn(B, H, lq, dh), randn(B, H, lk, dh)
        for mode in ("max", "mean", "std"):
            reduce_case(q, k, mode, f"Lq{lq} dh{dh}{f' Lk{lk}' if lk != LK else ''} {mode}")
    # SD-2.1 768-v: head dim 64 at every site, five sites of each per UNet
    # call (their calls per 30-step run join loss_ms_per_run)
    # SD-2.1 768-v, then SDXL base and refiner at 1024² (SDXL_SITES): head
    # dim 64 at every site, their calls per 30-step run join loss_ms_per_run
    # The serving path: 8 requests, CFG rows B = 16 (B·H 128) at SD-1.5's
    # 512² sites; the full-width long prompt's two windows (Lk 154) at B 2
    # are the Lk154 cases above
    for lq, dh in SHAPES:
        q, k, v = randn(16, H, lq, dh), randn(16, H, LK, dh), randn(16, H, LK, dh)
        for mode in ("max", "mean", "std"):
            reduce_case(q, k, mode, f"b8 Lq{lq} dh{dh} {mode}",
                        calls=5 * STEPS_PER_RUN if mode == "max" else None)
        xattn_case(q, k, v, f"b8 Lq{lq} dh{dh}", calls=5 * STEPS_PER_RUN)
        del q, k, v
        if lq >= 1024:
            flash_case(lq, dh, f"b8 L{lq} dh{dh}", calls=5 * STEPS_PER_RUN, B=16)
    for lq, dh in SHAPES[1:]:  # the long prompt's other two sites (Lq 4096: above)
        q, k, v = randn(B, H, lq, dh), randn(B, H, 2 * LK, dh), randn(B, H, 2 * LK, dh)
        for mode in ("max", "mean", "std"):
            reduce_case(q, k, mode, f"Lq{lq} dh{dh} Lk{2 * LK} {mode}")
        xattn_case(q, k, v, f"Lq{lq} dh{dh} Lk{2 * LK}")
    # the sampling extras: ToMe 0.5 merges the 512² L 4096 sites to L 2048
    # before K3; the hires fix's second pass at 1024² runs K1 and K2 at Lq
    # 16384 and K3 at L 16384 (B·H 16, dh 40), 5 sites a visit, 21 visits
    # at strength 0.7 (its L 1024 dh 160 and Lq 256 dh 160 sites are the
    # cases above). Plain K3 at L 16384 would hold 16·16384² f32 scores
    # (17.2 GB): the kernel runs on all 16 (sample, head) pairs, its plain
    # version on pairs 0 and 15, the kernel treating each pair on its own
    flash_case(2048, 40, "tome L2048 dh40", calls=5 * STEPS_PER_RUN)
    hires_calls = 5 * (STEPS_PER_RUN - t_start_from_strength(STEPS_PER_RUN, 0.7))
    q, k, v = randn(B, H, 16384, 40), randn(B, H, LK, 40), randn(B, H, LK, 40)
    for mode in ("max", "mean", "std"):
        reduce_case(q, k, mode, f"hires Lq16384 dh40 {mode}",
                    calls=hires_calls if mode == "max" else None)
    reduce_case(randn(B, H, 16384, 40, mean=4.0), randn(B, H, LK, 40, mean=4.0), "std",
                "hires Lq16384 dh40 std large-mean")
    xattn_case(q, k, v, "hires Lq16384 dh40", calls=hires_calls)
    del q, k, v
    flash_case(16384, 40, "hires L16384 dh40 (plain on pairs 0 and 15)", calls=hires_calls,
               plain_pairs=(0, B * H - 1))
    tables = [("sd21", {(h, lq, 64): 5 for lq, h in SD21_SHAPES})]
    tables += [("xl" if name == "sdxl" else "xlr", table) for name, table in SDXL_SITES.items()]
    for tag, table in tables:
        for (h, lq, dh), per_visit in table.items():
            calls = per_visit * STEPS_PER_RUN
            q, k, v = randn(B, h, lq, dh), randn(B, h, LK, dh), randn(B, h, LK, dh)
            for mode in ("max", "mean", "std"):
                reduce_case(q, k, mode, f"{tag} Lq{lq} H{h} dh{dh} {mode}",
                            calls=calls if mode == "max" else None)
            reduce_case(randn(B, h, lq, dh, mean=4.0), randn(B, h, LK, dh, mean=4.0), "std",
                        f"{tag} Lq{lq} H{h} dh{dh} std large-mean")
            xattn_case(q, k, v, f"{tag} Lq{lq} H{h} dh{dh}", calls=calls)
            del q, k, v
            if lq >= 1024:
                flash_case(lq, dh, f"{tag} L{lq} H{h} dh{dh}", calls=calls, H=h)
    for name, cs in cases.by_kernel.items():
        tagged = {tag: [c for c in cs if c["case"].startswith(tag + " ")]
                  for tag in ["b8", "tome", "hires"] + [tag for tag, _ in tables]}
        plain = [c for c in cs if not any(c in t for t in tagged.values())]
        log(f"[kernels] {name}: loss_ms_per_run SD-1.5 512² {loss_ms_per_run(plain):.3f}, "
            f"batch 8 {loss_ms_per_run(tagged['b8']):.3f}, ToMe 0.5 "
            f"{loss_ms_per_run(tagged['tome']):.3f}, hires 1024² second pass "
            f"{loss_ms_per_run(tagged['hires']):.3f}, "
            f"SD-2.1 768² {loss_ms_per_run(tagged['sd21']):.3f}, SDXL 1024² "
            f"{loss_ms_per_run(tagged['xl']):.3f}, refiner 1024² "
            f"{loss_ms_per_run(tagged['xlr']):.3f}")
    cases.check()
    return cases.by_kernel


def phase_reference():
    """Reduced-depth SD-1.5-width txt2img: card bf16 vs CPU f32."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import synthetic_params

    clip = CLIPTextConfig.tiny()
    cfg = SDModelConfig(
        clip=clip,
        unet=UNetConfig(block_out_channels=(320, 640), layers_per_block=1,
                        down_block_has_attn=(True, False), cross_attention_dim=clip.hidden_size),
        vae=VAEConfig.tiny(),
    )
    # std 0.1 rather than 0.02, so that three steps move the latents well
    # away from the initial noise and the comparison sees the UNet's output
    params = synthetic_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    cm[:, 128:] = (0, 0, 255)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True)
    gpu = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16).generate(**kw)
    ref = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32).generate(**kw)
    rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
    ok = np.isfinite(gpu).all() and rel < 5e-2
    log(f"[reference] 256 px, 3 steps, (320, 640)-channel UNet: card bf16 vs CPU f32 "
        f"relative L2 error {rel:.3e} (tol 5e-2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[reference] card run disagrees with the CPU reference")


def phase_main_path(steps):
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig.sd15()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    n_params = sum(v.numel() for sd in params.values() for v in sd.values())
    pipe = PwwPipeline(cfg, params=params, tokenizer=synthetic_tokenizer(49408),
                       device="cuda", dtype=torch.bfloat16, profile=True)
    del params
    torch.cuda.synchronize()
    log(f"[main] SD-1.5, {n_params:.4e} parameters in bf16 on the card, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=cm, input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, preloaded_utils=pipe, device="cuda",
              output_type="np")
    paint_with_words(num_inference_steps=2, **kw)  # warm-up: cuDNN plans, allocator

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = paint_with_words(num_inference_steps=steps, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    log(f"[main] paint_with_words 512², {steps} LMS steps, CFG 7.5: encode "
        f"{tm['encode']:.3f} s, denoise {tm['denoise']:.3f} s "
        f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s, "
        f"{total:.3f} s/image, peak {peak:.2f} GiB")
    log(f"[main] launches: {launches}")
    lat = pipe.generate(prompt=kw["input_prompt"], color_map_image=cm,
                        color_context=kw["color_context"], num_inference_steps=steps,
                        seed=0, return_latents=True)
    problems = []
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8:
        problems.append(f"image {img.shape} {img.dtype}")
    if not np.isfinite(lat).all() or lat.shape != (1, 64, 64, 4):
        problems.append(f"latents {lat.shape}, finite={np.isfinite(lat).all()}")
    if img.std() == 0:
        problems.append("constant image")
    want = path_launches(steps)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    log(f"[main] image {img.shape} {img.dtype} mean {img.mean():.2f} std {img.std():.2f}; "
        f"latents finite, |max| {np.abs(lat).max():.3f}")
    if problems:
        raise SystemExit(f"[main] {problems}")
    return launches, pipe, kw


def phase_e2e(reps, steps):
    """The main path's s/image ``reps`` times on one pipeline, and the host
    time each K2/K3 wrapper call takes to enqueue (the card held busy by a
    spin kernel meanwhile), for A/B runs of two trees."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig.sd15()
    pipe = PwwPipeline(cfg, params=synthetic_params(cfg, seed=0, device="cuda",
                                                    dtype=torch.bfloat16),
                       tokenizer=synthetic_tokenizer(49408), device="cuda",
                       dtype=torch.bfloat16, profile=True)
    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=cm, input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, preloaded_utils=pipe, device="cuda",
              output_type="np")
    paint_with_words(num_inference_steps=2, **kw)
    for rep in range(reps):
        t0 = time.perf_counter()
        paint_with_words(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        log(f"[e2e] rep {rep}: {total:.3f} s/image, denoise "
            f"{pipe.timings['denoise'] / steps * 1e3:.1f} ms/step")
    phase_e2e_controlnet(pipe, kw, cm, reps, steps)
    import pww_tpu_torch.models.unet as unet_mod

    names = ("fused_pww_reduce", "fused_pww_cross_attention", "flash_self_attention")
    spent = dict.fromkeys(names, 0.0)

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            return out
        return call

    wrapped = {n: getattr(unet_mod, n) for n in names}
    for n, fn in wrapped.items():
        setattr(unet_mod, n, timed(n, fn))
    try:
        paint_with_words(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
    finally:
        for n, fn in wrapped.items():
            setattr(unet_mod, n, fn)
    log(f"[e2e] host ms per step inside the UNet's kernel wrappers: " + ", ".join(
        f"{n} {t / steps * 1e3:.2f}" for n, t in spent.items()) + f"; denoise "
        f"{pipe.timings['denoise'] / steps * 1e3:.1f} ms/step in that call")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 8, 4096, 40), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kx, vx = k[:, :, :77].contiguous(), v[:, :, :77].contiguous()
    w = torch.rand((2, 4096, 77), generator=g, device="cuda")
    coef = torch.ones(2, device="cuda")
    for name, fn in (("K2", lambda: xk.fused_pww_cross_attention(q, kx, vx, w, coef)),
                     ("K3", lambda: fa.flash_self_attention(q, k, v))):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # about a second of device time
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        log(f"[e2e] {name} wrapper at the L 4096 shape: {host_us:.1f} us of host time per call")


def phase_e2e_controlnet(pipe, kw, cm, reps, steps):
    """txt2img and txt2img with a ControlNet in turns, ``reps`` times each;
    then one ControlNet call with the host time inside ``UNet.forward`` and
    ``ControlNetModel.forward`` (no synchronisation: what the host spends
    enqueueing) and the synchronising operations it makes, as
    ``torch.cuda.set_sync_debug_mode`` reports them."""
    import collections
    import warnings

    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.models.controlnet import ControlNetModel
    from pww_tpu_torch.models.unet import UNet2DConditionModel
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.weights.bridge import synthetic_params

    pipe.load_controlnet(params=synthetic_params(SDModelConfig.sd15(), seed=1, device="cuda",
                                                 parts=("controlnet",))["controlnet"])
    hint = edge_hint(cm)
    paint_with_words(num_inference_steps=2, control_image=hint, **kw)
    for rep in range(reps):
        for name, extra in (("txt2img", {}), ("controlnet", {"control_image": hint})):
            t0 = time.perf_counter()
            paint_with_words(num_inference_steps=steps, **kw, **extra)
            torch.cuda.synchronize()
            log(f"[e2e] {name} rep {rep}: {time.perf_counter() - t0:.3f} s/image, denoise "
                f"{pipe.timings['denoise'] / steps * 1e3:.1f} ms/step")
    host = {UNet2DConditionModel: 0.0, ControlNetModel: 0.0}
    forwards = {cls: cls.forward for cls in host}

    def timed(cls):
        def forward(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = forwards[cls](self, *args, **kwargs)
            host[cls] += time.perf_counter() - t0
            return out
        return forward

    for cls in host:
        cls.forward = timed(cls)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            paint_with_words(num_inference_steps=steps, control_image=hint, **kw)
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for cls, fwd in forwards.items():
            cls.forward = fwd
    syncs = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    log(f"[e2e] controlnet call: host ms per step inside UNet.forward "
        f"{host[UNet2DConditionModel] / steps * 1e3:.2f}, ControlNetModel.forward "
        f"{host[ControlNetModel] / steps * 1e3:.2f}; denoise "
        f"{pipe.timings['denoise'] / steps * 1e3:.1f} ms/step in that call")
    log(f"[e2e] synchronising operations in that call (file:line → count): {dict(syncs)}")
    pipe.controlnets = []


def launch_counters():
    """Every kernel wrapper, K1-K5; each counts its own launches."""
    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    return (xk.fused_pww_reduce, xk.fused_pww_cross_attention, fa.flash_self_attention,
            gn.group_norm, ln.layer_norm)


GROUPS = (  # device-kernel name fragments → group, first match wins
    ("K1 pww_reduce", ("pww_reduce_kernel",)),
    ("K2 pww_cross_attention", ("pww_xattn_kernel",)),
    ("K3 flash_self_attention", ("flash_kernel",)),
    ("K4 group_norm", ("gn_cluster",)),
    ("K5 layer_norm", ("ln_rows",)),
    ("conv", ("conv", "xmma", "implicit", "winograd", "fprop")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
)


def phase_profile(run, tag, steps=5):
    """Device time by kernel group over one ``run(steps)`` call (torch.profiler);
    returns {group: (device ms, device kernels) per wrapper call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    counters = dict(zip((g for g, _ in GROUPS), launch_counters()))
    for c in counters.values():
        c.launches = 0
    # A warm-up step with the device trace on, whose events are dropped: the
    # trace starts a little after the profiler does, and late in the script
    # the first device kernels of a call went unrecorded (a K4 among them),
    # even after a 0.2 s wait
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(8):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        prof.step()
        # and the active step's first device kernels can go unrecorded too
        # (2 of SDXL-inpainting's 166 K4 calls once): let them be these
        for _ in range(32):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    groups, counts, kernels = {}, {}, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        name = ev.key
        if us <= 0 or name.startswith("ProfilerStep"):  # the schedule's step range
            continue
        group = next((g for g, frags in GROUPS
                      if any(f in name.lower() for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        counts[group] = counts.get(group, 0) + ev.count
        kernels.append((us / 1e3, ev.count, name))
    busy = sum(groups.values())
    if busy == 0:
        raise SystemExit(f"[profile {tag}] the trace holds no device time")
    log(f"[profile {tag}] {steps}-step call: {wall * 1e3:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}, "
        f"{sum(counts.values())} device kernels")
    log(f"[profile {tag}] by group (ms): " + ", ".join(
        f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda x: -x[1])))
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"[profile {tag}]   {ms:8.2f} ms {count:6d}x {name[:90]}")
    per_launch = {g: (groups.get(g, 0.0) / c.launches, counts.get(g, 0) / c.launches)
                  for g, c in counters.items() if c.launches}
    log(f"[profile {tag}] device ms per wrapper call: " + ", ".join(
        f"{g} {t:.4f}" for g, (t, _) in per_launch.items()))
    log(f"[profile {tag}] device kernels per wrapper call: " + ", ".join(
        f"{g} {k:g}" for g, (_, k) in per_launch.items()))
    return per_launch


def synthetic_init_image(size=512, seed=0):
    """A smooth RGB image with texture, from a numpy seed (uint8, HWC)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([xx, yy, 0.5 + 0.5 * np.sin(xx * 20.0)], -1) * 220.0
    return np.clip(img + rng.normal(0, 15, img.shape), 0, 255).astype(np.uint8)


def box_mask(size=512):
    import numpy as np

    m = np.zeros((size, size), np.float32)
    m[size // 4: 3 * size // 4, size // 3: 5 * size // 6] = 1.0
    return m


def phase_img2img(pipe, kw, steps):
    """One full-width img2img call (strength 0.5) on the main pipeline."""
    import torch

    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.schedulers.schedules import t_start_from_strength

    run = steps - t_start_from_strength(steps, 0.5)
    init = synthetic_init_image()
    paint_with_words(num_inference_steps=2, init_image=init, strength=0.5, **kw)  # warm-up
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    img = paint_with_words(num_inference_steps=steps, init_image=init, strength=0.5, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    tm = pipe.timings
    log(f"[img2img] 512², strength 0.5, {run} of {steps} LMS steps: encode "
        f"{tm['encode']:.3f} s (VAE encode included), denoise {tm['denoise']:.3f} s, decode "
        f"{tm['decode']:.3f} s, {total:.3f} s/image; launches {launches}")
    want = path_launches(run, encodes=1)
    if launches != want or img.shape != (1, 512, 512, 3) or img.std() == 0:
        raise SystemExit(f"[img2img] launches {launches} != {want}, or image "
                         f"{img.shape} std {img.std():.2f}")


# The mesh phase: two ranks share the card over gloo, at SD-1.5 width, 512²,
# MESH_STEPS LMS steps, MESH_SAMPLES samples. Each rank's decoded images
# against the one-process call's, relative L2: dp 2 only splits the batch; at
# tp 2 the to_out / ff.net.2 partial products are summed in bf16. Set before
# the first run on the card.
MESH_STEPS = 4
MESH_SAMPLES = 2
MESH_TOL = {(2, 1): 5e-3, (1, 2): 1e-2}
# At tp 2 the first K1 site's per-sample reduction r, combined over the two
# ranks, against the one-process r, relative per sample; and the control:
# some rank's own r (before the combine) must miss the one-process r by more,
# so that this gate can see a missing combine, which the rank-equality check
# cannot (the to_out sum makes both ranks' images equal either way).
MESH_R_TOL = 1e-2
SD15_BLOCKS, SD15_PWW_SITES = 16, 16  # transformer blocks; PwW cross-attentions (15 K1 + 1 dense)


def mesh_kwargs(steps):
    """The main path's prompt and color map, MESH_SAMPLES samples."""
    import numpy as np

    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    return dict(prompt="a cat sitting next to a dog, realistic photo", color_map_image=cm,
                color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
                guidance_scale=7.5, seed=0, num_samples=MESH_SAMPLES,
                num_inference_steps=steps)


def sd15_pipeline(mesh=None, profile=True):
    """phase_main_path's SD-1.5 pipeline (synthetic weights from seed 0), on
    ``mesh``."""
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig.sd15()
    params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    return PwwPipeline(cfg, params=params, tokenizer=synthetic_tokenizer(49408), device="cuda",
                       dtype=torch.bfloat16, profile=profile, mesh=mesh)


def mesh_run(pipe, steps):
    """One warm-up, then the timed call with every counter zeroed before it
    and read after it: (images, latents, launches, collectives, K1's B·H
    set, ms per step, r), r the timed call's first K1 site's reduction
    (B,) on the host as (this rank's, combined over tp); without tp the two
    are the same."""
    import torch

    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.parallel import mesh as pmesh
    from pww_tpu_torch.parallel.tp import TensorParallel

    pipe.generate(output_type="np", **mesh_kwargs(2))
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    pmesh.COLLECTIVES.clear()
    k1, combine, bh, first = unet_mod.fused_pww_reduce, TensorParallel.combine_reduce, set(), {}

    def spy(q, *args):
        bh.add(q.shape[0] * q.shape[1])
        r = k1(q, *args)
        if "local" not in first:  # before an in-place combine; once, not a sync a call
            first["local"] = r.cpu().numpy()
        return r

    def combine_spy(self, *args):
        r = combine(self, *args)
        if "combined" not in first:
            first["combined"] = r.cpu().numpy()
        return r

    unet_mod.fused_pww_reduce, TensorParallel.combine_reduce = spy, combine_spy
    try:
        with EagerLoop():  # the spies see every visit's Python calls
            images = pipe.generate(output_type="np", **mesh_kwargs(steps))
    finally:
        unet_mod.fused_pww_reduce, TensorParallel.combine_reduce = k1, combine
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    collectives = dict(pmesh.COLLECTIVES)
    ms = pipe.timings["denoise"] / steps * 1e3
    latents = pipe.generate(return_latents=True, **mesh_kwargs(steps))
    r = (first["local"], first.get("combined", first["local"]))
    return images, latents, launches, collectives, sorted(bh), ms, r


def mesh_rank(rank, steps):
    """A gloo rank on the shared card: the (2, 1) mesh (batch sharding, then
    spatial txt2img and serving), the (1, 2) mesh (batch sharding, then
    textual inversion and LoRA through the tp cut), SD-1.5-inpainting on
    the (2, 1) mesh (spatial, the norm kernels on), then the spatial modes
    (:func:`spatial_modes`) on the (2, 1) mesh."""
    import torch

    from pww_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dp, tp in MESH_TOL:
        pipe = sd15_pipeline(make_mesh(dp, tp, device_type="cuda"))
        out[dp, tp] = mesh_run(pipe, steps)
        if dp == 2:
            out["spatial"] = spatial_run(pipe, mesh_kwargs(steps))
            out["serve"] = mesh_serve(pipe, rank, steps)
        else:
            out["train"] = mesh_train(pipe)
        del pipe
        torch.cuda.empty_cache()
    pipe, _ = inpaint_pipeline(make_mesh(2, 1, device_type="cuda"))
    out["spatial inpaint"] = spatial_run(pipe, inpaint_kwargs(steps))
    del pipe
    torch.cuda.empty_cache()
    out["modes"] = spatial_modes(make_mesh(2, 1, device_type="cuda"), steps)
    return out


def phase_mesh(pipe, card, train_ref, steps=MESH_STEPS):
    """PwwPipeline(mesh=...) on two gloo ranks sharing the card at dp 2 and
    at tp 2, held against the one-process call on ``pipe`` (phase 5's, the
    same weights); spatial sharding, serving and tp training on the same
    ranks (:func:`check_spatial_serve_train`; ``train_ref``: phase_train's
    runs), and the spatial modes (:func:`check_spatial_modes`); then NCCL
    at world size 1. Returns {run: launches}."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from pww_tpu_torch.parallel.mesh import init_multihost, make_mesh, spawn

    t0 = time.perf_counter()
    want_img, want_lat, ref_launches, _, ref_bh, ref_ms, (want_r, _) = mesh_run(pipe, steps)
    log(f"[mesh] one process: {steps} LMS steps, {MESH_SAMPLES} samples, {ref_ms:.1f} ms/step, "
        f"K1 B·H {ref_bh}, launches {ref_launches} | card: {card}")
    s_img, s_lat, _, _, _, (s_r, _), s_qk = spatial_run(pipe, mesh_kwargs(steps), spatial=False)
    modes = spatial_modes(None, steps)  # its pipelines freed before the ranks build theirs
    torch.cuda.empty_cache()
    ranks = spawn(mesh_rank, 2, "gloo", steps)
    problems, out = check_spatial_serve_train(pipe, ranks, card, steps,
                                              (s_img, s_lat, s_r, s_qk), train_ref)
    problems += check_spatial_modes([r["modes"] for r in ranks], modes, card, steps, out)
    for (dp, tp), tol in MESH_TOL.items():
        per = [r[dp, tp] for r in ranks]
        tag = f"dp={dp} tp={tp}"
        for r, (img, lat, launches, coll, bh, ms, _) in enumerate(per):
            err_img, err_lat = rel_l2(img, want_img), rel_l2(lat, want_lat)
            log(f"[mesh] {tag} rank {r} (gloo, two ranks on one card): {ms:.1f} ms/step, "
                f"image rel L2 {err_img:.3e} (tol {tol:g}), latents rel L2 {err_lat:.3e}, "
                f"K1 B·H {bh}, launches {launches}, collectives {coll} | card: {card}")
            want_launch = path_launches(steps)
            want_coll = ({} if tp == 1 else {"sum": 3 * SD15_BLOCKS * steps,
                                             "reduce": SD15_PWW_SITES * steps})
            want_bh = [2 * MESH_SAMPLES // dp * 8 // tp]
            if launches != want_launch or coll != want_coll or bh != want_bh:
                problems.append(f"{tag} rank {r}: launches {launches} != {want_launch}, "
                                f"collectives {coll} != {want_coll} or B·H {bh} != {want_bh}")
            if not (err_img <= tol and err_lat <= tol and np.isfinite(lat).all()
                    and img.shape == want_img.shape):
                problems.append(f"{tag} rank {r}: image {img.shape} rel L2 {err_img:.3e}, "
                                f"latents {err_lat:.3e} > {tol}")
        if not (np.array_equal(per[0][0], per[1][0]) and np.array_equal(per[0][1], per[1][1])):
            problems.append(f"{tag}: the two ranks' results differ")
        if tp > 1:
            def rel(a):
                return float(np.max(np.abs(a - want_r) / np.abs(want_r)))

            err_comb = [rel(res[6][1]) for res in per]
            err_own = [rel(res[6][0]) for res in per]
            log(f"[mesh] {tag}: first K1 site's r against the one-process r, per-sample "
                f"relative: combined {err_comb}, each rank's own {err_own} "
                f"(tol {MESH_R_TOL:g}; the own r must miss it on some rank)")
            if max(err_comb) > MESH_R_TOL or max(err_own) <= MESH_R_TOL:
                problems.append(f"{tag}: K1's r combined {err_comb} > {MESH_R_TOL}, or no "
                                f"rank's own r {err_own} misses it (the gate cannot see a "
                                f"missing combine)")
        out[f"dp{dp}_tp{tp}"] = per[0][2]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_multihost(f"localhost:{port}", num_processes=1, process_id=0, backend="nccl")
    try:
        mesh_pipe = sd15_pipeline(make_mesh(1, 1, device_type="cuda"))
        img, lat, launches, coll, _, ms, _ = mesh_run(mesh_pipe, steps)
        log(f"[mesh] NCCL world size 1 (dp=1 tp=1): {ms:.1f} ms/step, bit-equal images "
            f"{np.array_equal(img, want_img)}, latents {np.array_equal(lat, want_lat)}, "
            f"launches {launches} | card: {card}")
        if not (np.array_equal(img, want_img) and np.array_equal(lat, want_lat)):
            problems.append("NCCL world size 1: not bit-equal to the call without a mesh")
        out["nccl_dp1_tp1"] = launches
        del mesh_pipe
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"[mesh] {time.perf_counter() - t0:.1f} s in all")
    if problems:
        raise SystemExit(f"[mesh] {problems}")
    return out


# -- spatial sharding, serving and training over the mesh ---------------------------

# dp 2 spatial calls (phase_mesh) against the one-process call on the same
# weights, relative L2 of images and latents: MESH_TOL's tp limit, the halo
# convolutions and the moments combined over rows reorder bf16 work as the
# tp sums do. Set before the first run on the card.
SPATIAL_TOL = 1e-2
# tp-2 training (3 TI and 3 LoRA steps, bf16) against phase_train's
# one-process runs on the same weights, images and seeds: each step's loss,
# relative; the trained rows' and the gathered factors' updates (trained
# minus initial), relative L2. Set before the first run on the card.
MESH_TRAIN_TOL = {"loss": 2e-2, "update": 2e-1}
MESH_SERVE_REQUESTS = 4


def spatial_collectives(cfg, unet_visits, decodes):
    """Collectives of a sharding="spatial" call whose every level dp
    divides, by kind, from the config: per UNet visit a halo exchange for
    each 3×3 convolution (conv_in, two per resnet, each upsampler, conv_out)
    and each downsample, a moments combine for each GroupNorm (two per
    resnet, one per transformer, conv_norm_out), a K/V gather and a PwW
    reduction combine for each transformer block; per decode the VAE
    decoder's (conv_in, two per resnet, the upsamplers, conv_out; two
    GroupNorms per resnet, the mid attention's, conv_norm_out; one K/V
    gather)."""
    u = cfg.unet
    n, per = len(u.block_out_channels), u.layers_per_block
    resnets = n * per + 2 + n * (per + 1)
    attn = ([(i, per) for i in range(n) if u.down_block_has_attn[i]]
            + [(n - 1, 1)] + [(n - 1 - i, per + 1) for i in range(n) if u.up_block_has_attn[i]])
    sites = sum(k for _, k in attn)
    blocks = sum(k * u.depth_for(level) for level, k in attn)
    v = cfg.vae
    m = len(v.block_out_channels)
    vres = 2 + m * (v.layers_per_block + 1)
    return {"halo": (2 + 2 * resnets + 2 * (n - 1)) * unet_visits
            + (2 + 2 * vres + m - 1) * decodes,
            "norm": (2 * resnets + sites + 1) * unet_visits + (2 * vres + 2) * decodes,
            "kv": blocks * unet_visits + decodes, "r": blocks * unet_visits}


def inpaint_kwargs(steps):
    """The inpaint path's call (inpaint_pipeline's) as ``generate`` takes it."""
    import numpy as np

    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    return dict(prompt="a cat sitting next to a dog, realistic photo", color_map_image=cm,
                color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
                init_image=synthetic_init_image(), mask_image=box_mask(), strength=1.0,
                guidance_scale=7.5, seed=0, num_inference_steps=steps)


def spatial_run(pipe, kw, spatial=True):
    """A sharding="spatial" call (``spatial=False``: the same call in one
    process) with every counter zeroed before it and read after it:
    (images, latents, launches incl. split K4's, collectives, ms per step,
    (this rank's r, r combined over dp) at the first K1 site, and that
    site's q and k in one process)."""
    import torch

    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.parallel import mesh as pmesh
    from pww_tpu_torch.parallel.spatial import Spatial

    extra = dict(sharding="spatial") if spatial else {}
    counters = launch_counters() + (gn.group_norm_stats, gn.group_norm_apply)
    for c in counters:
        c.launches = 0
    pmesh.COLLECTIVES.clear()
    k1, combine, first = unet_mod.fused_pww_reduce, Spatial.combine_reduce, {}

    def spy(q, k, *args):
        r = k1(q, k, *args)
        if "local" not in first:  # a copy: the combine over dp is in place
            first["local"], first["qk"] = r.clone().cpu().numpy(), (q.clone(), k.clone())
        return r

    def combine_spy(self, *args):
        r = combine(self, *args)
        if "combined" not in first:
            first["combined"] = r.cpu().numpy()
        return r

    unet_mod.fused_pww_reduce, Spatial.combine_reduce = spy, combine_spy
    try:
        with EagerLoop():  # the spies see every visit's Python calls
            images = pipe.generate(output_type="np", **extra, **kw)
    finally:
        unet_mod.fused_pww_reduce, Spatial.combine_reduce = k1, combine
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    coll = dict(pmesh.COLLECTIVES)
    ms = pipe.timings["denoise"] / kw["num_inference_steps"] * 1e3
    latents = pipe.generate(return_latents=True, **extra, **kw)
    qk = None if spatial else first["qk"]
    return (images, latents, launches, coll, ms,
            (first["local"], first.get("combined", first["local"])), qk)


def mesh_serve(pipe, rank, steps):
    """Rank 0: a Batcher over the (2, 1) mesh pipeline, 4 requests submitted
    together, then one POST /generate through make_handler on a localhost
    server; rank 1 follows. Returns rank 0's (images, the POST's image,
    launches, Batcher stats), rank 1's follow counts."""
    import base64
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from pww_tpu_torch.serving.batcher import Batcher, follow
    from pww_tpu_torch.serving.server import make_handler

    if rank != 0:
        return follow(pipe)
    reqs = serve_requests(steps, n=MESH_SERVE_REQUESTS + 1)
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    batcher = Batcher(pipe, max_batch=MESH_SERVE_REQUESTS, max_wait_ms=1000.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        futs = [batcher.submit(dict(r)) for r in reqs[:MESH_SERVE_REQUESTS]]
        images = np.stack([np.asarray(f.result(timeout=600)) for f in futs])
        req = reqs[-1]
        buf = io.BytesIO()
        Image.fromarray(req["color_map_image"]).save(buf, format="PNG")
        body = {"prompt": req["prompt"], "seed": req["seed"], "steps": steps,
                "guidance_scale": req["guidance_scale"],
                "color_context": {str(k): v for k, v in req["color_context"].items()},
                "color_map_png_b64": base64.b64encode(buf.getvalue()).decode()}
        post = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(post, timeout=600) as r:
            out = json.loads(r.read())
        posted = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"]))))
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        batcher.close()
    return images, posted, {c.__name__: c.launches for c in counters}, dict(batcher.stats)


def mesh_train(pipe):
    """phase_train's textual inversion and LoRA runs on the (1, 2) mesh: the
    UNet cut over tp 2. Returns (TI losses, trained rows, LoRA losses,
    gathered factors, {trainer: K3 launches})."""
    from pww_tpu_torch.ops import flash_attention as fa
    from pww_tpu_torch.training import train_lora, train_textual_inversion

    images, k3 = train_images(), {}
    fa.flash_self_attention.launches = 0
    ti = train_textual_inversion(pipe, images, "<pww-toy>", initializer_token="toy",
                                 num_steps=TRAIN_STEPS, seed=0)
    k3["ti"] = fa.flash_self_attention.launches
    fa.flash_self_attention.launches = 0
    lora = train_lora(pipe, images, "a photo of a pww toy", rank=8, num_steps=TRAIN_STEPS,
                      learning_rate=TRAIN_LORA_LR, seed=0)
    k3["lora"] = fa.flash_self_attention.launches
    return ti.losses, ti.embedding.numpy(), lora.losses, {
        k: {n: t.numpy() for n, t in f.items()} for k, f in lora.factors.items()}, k3


def head_cut_combine(q, k):
    """The tp-2 combine of phase_mesh's r gate on one process's whole q and
    k of the first K1 site, only the heads cut: per mode, the largest
    per-sample relative difference from K1 on all heads."""
    import torch

    from pww_tpu_torch.ops.cross_attention_kernel import fused_pww_reduce
    from pww_tpu_torch.ops.weight_functions import WeightFunction

    h = q.shape[1] // 2
    out = {}
    for mode in ("max", "mean", "std"):
        wf = WeightFunction(0.1, "log1p_sigma", mode)
        whole = fused_pww_reduce(q, k, wf).double()
        parts = [(q[:, i * h:(i + 1) * h].contiguous(), k[:, i * h:(i + 1) * h].contiguous())
                 for i in range(2)]
        rs = [fused_pww_reduce(qq, kk, wf).double() for qq, kk in parts]
        if mode == "max":
            got = torch.maximum(rs[0], rs[1])
        elif mode == "mean":
            got = (rs[0] / 2 + rs[1] / 2)
        else:  # Chan's rule over the two halves' (mean, M2), as parallel.tp.combine
            n = h * q.shape[2] * k.shape[2]
            mwf = WeightFunction(0.1, "log1p_sigma", "mean")
            means = [fused_pww_reduce(qq, kk, mwf).double() for qq, kk in parts]
            mean = (means[0] + means[1]) / 2
            m2 = sum(r * r * (n - 1) for r in rs) + n * sum((m - mean) ** 2 for m in means)
            got = (m2 / (2 * n - 1)).sqrt()
        out[mode] = ((got - whole) / whole).abs().max().item()
    return out


def check_spatial_serve_train(pipe, ranks, card, steps, want, train_ref):
    """The checks of the last slice on phase_mesh's two ranks: spatial txt2img
    (against ``want``, phase_mesh's one-process run) and inpaint (against a
    one-process inpaint call here), serving, tp training (against
    ``train_ref``, phase_train's runs). Returns (problems, {run: launches})."""
    import numpy as np
    import torch

    want_img, want_lat, want_r, want_qk = want
    problems, out = [], {}
    # -- the tp combine of the r gate: the whole q and k, only the heads cut
    err = head_cut_combine(*want_qk)
    log(f"[mesh] first K1 site, one process's whole bf16 q and k, heads cut in two and the "
        f"r combined as over tp: largest per-sample relative difference from K1 on all heads "
        f"{err} | card: {card}")
    if max(err.values()) > 1e-5:
        problems.append(f"the head-cut combine alone misses the one-process r: {err}")
    # -- spatial txt2img and inpaint at dp 2
    ipipe, _ = inpaint_pipeline()
    ikw = inpaint_kwargs(steps)
    spatial_run(ipipe, dict(ikw, num_inference_steps=1), spatial=False)  # warm-up
    i_img, i_lat, i_launches, _, i_ms, _, _ = spatial_run(ipipe, ikw, spatial=False)
    del ipipe
    torch.cuda.empty_cache()
    log(f"[mesh] inpaint one process: {steps} steps, {i_ms:.1f} ms/step, launches "
        f"{i_launches} | card: {card}")
    from pww_tpu_torch.config import SDModelConfig

    cfg_t, cfg_i = SDModelConfig.sd15(), inpaint_config()
    for tag, ref_img, ref_lat, cfg in (("spatial", want_img, want_lat, cfg_t),
                                       ("spatial inpaint", i_img, i_lat, cfg_i)):
        per = [r[tag] for r in ranks]
        inpaint = tag.endswith("inpaint")
        want_coll = spatial_collectives(cfg, steps, 1)
        # every GroupNorm on a rank's rows is split K4, a pair of launches;
        # the encoder runs whole on each rank (K4); K5 on the rank's tokens
        want_launch = dict(path_launches(steps), group_norm=SD15_NORMS[2] * 2 if inpaint else 0,
                           group_norm_stats=want_coll["norm"],
                           group_norm_apply=want_coll["norm"])
        for r, (img, lat, launches, coll, ms, rr, _) in enumerate(per):
            err_img, err_lat = rel_l2(img, ref_img), rel_l2(lat, ref_lat)
            got_coll = {kind: coll.get(kind, 0) for kind in want_coll}
            log(f"[mesh] {tag} dp=2 rank {r} (gloo, two ranks on one card; not a scaling "
                f"number): {ms:.1f} ms/step, image rel L2 {err_img:.3e}, latents rel L2 "
                f"{err_lat:.3e} (tol {SPATIAL_TOL:g}), launches {launches}, collectives "
                f"{coll} (want {want_coll}) | card: {card}")
            if launches != want_launch or got_coll != want_coll:
                problems.append(f"{tag} rank {r}: launches {launches} != {want_launch} or "
                                f"collectives {got_coll} != {want_coll}")
            if not (err_img <= SPATIAL_TOL and err_lat <= SPATIAL_TOL
                    and np.isfinite(lat).all() and img.shape == ref_img.shape):
                problems.append(f"{tag} rank {r}: image rel L2 {err_img:.3e}, latents "
                                f"{err_lat:.3e} > {SPATIAL_TOL}")
        if not (np.array_equal(per[0][0], per[1][0]) and np.array_equal(per[0][1], per[1][1])):
            problems.append(f"{tag}: the two ranks' results differ")
        out[tag.replace(" ", "_")] = per[0][2]
        if not inpaint:  # K1's r over the rows: combined, and each rank's own
            def rel(a):
                return float(np.max(np.abs(a - want_r) / np.abs(want_r)))

            comb, own = [rel(p[5][1]) for p in per], [rel(p[5][0]) for p in per]
            log(f"[mesh] spatial dp=2: first K1 site's r against the one-process r, "
                f"per-sample relative: combined over dp {comb}, each rank's own {own} "
                f"(tol {MESH_R_TOL:g}; the own r must miss it on some rank)")
            if max(comb) > MESH_R_TOL or max(own) <= MESH_R_TOL:
                problems.append(f"spatial: K1's r combined {comb} > {MESH_R_TOL}, or no "
                                f"rank's own r {own} misses it")
    # -- serving at dp 2
    images, posted, launches, stats = ranks[0]["serve"]
    reqs = serve_requests(steps, n=MESH_SERVE_REQUESTS + 1)
    ref = pipe.generate_batch([dict(r) for r in reqs[:MESH_SERVE_REQUESTS]],
                              num_inference_steps=steps, guidance_scale=7.5, output_type="np")
    ref_post = pipe.generate_batch([dict(reqs[-1])], num_inference_steps=steps,
                                   guidance_scale=7.5, output_type="np")[0]
    errs = [rel_l2(a, b) for a, b in zip(images, ref)] + [rel_l2(posted, ref_post)]
    log(f"[mesh] serve dp=2: rank 0's Batcher ({MESH_SERVE_REQUESTS} requests together, "
        f"then one POST /generate), rank 1 following {ranks[1]['serve']}; stats {stats}, "
        f"launches {launches}; each image against one process's generate_batch, rel L2 "
        f"{[f'{e:.3e}' for e in errs]} (tol {SERVE_IMAGE_TOL:g}) | card: {card}")
    want_launch = path_launches(steps)
    want_launch = {k: 2 * v for k, v in want_launch.items()}  # the group and the POST
    if (max(errs) > SERVE_IMAGE_TOL or ranks[1]["serve"] != {"calls": 2, "errors": 0}
            or stats["batches"] != 2 or launches != want_launch):
        problems.append(f"serve: rel L2 {errs}, follower {ranks[1]['serve']}, stats {stats}, "
                        f"launches {launches} != {want_launch}")
    out["serve"] = launches
    # -- training at tp 2
    ti_w, emb_w, lora_w, fac_w, init_w = train_ref
    keys = sorted(fac_w)

    def update(fac, init):
        return np.concatenate([(fac[k][n] - init[k][n]).ravel() for k in keys for n in "ab"])

    ranks_train = [x["train"] for x in ranks]
    for r, (ti_l, emb, lora_l, fac, k3) in enumerate(ranks_train):
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(ti_l + lora_l, ti_w + lora_w))
        emb_err = rel_l2(emb - init_w["emb"], emb_w - init_w["emb"])
        fac_err = rel_l2(update(fac, init_w["lora"]), update(fac_w, init_w["lora"]))
        log(f"[mesh] train tp=2 rank {r}: TI losses {ti_l} (one process {ti_w}), LoRA losses "
            f"{lora_l} (one process {lora_w}), largest relative loss difference "
            f"{loss_err:.3e} (tol {MESH_TRAIN_TOL['loss']:g}); trained rows' update rel L2 "
            f"{emb_err:.3e}, gathered factors' update rel L2 {fac_err:.3e} (tol "
            f"{MESH_TRAIN_TOL['update']:g}); K3 launches under autograd {k3} | card: {card}")
        if (loss_err > MESH_TRAIN_TOL["loss"] or emb_err > MESH_TRAIN_TOL["update"]
                or fac_err > MESH_TRAIN_TOL["update"] or sorted(fac) != keys
                or k3 != {"ti": TRAIN_K3_PER_STEP * TRAIN_STEPS,
                          "lora": TRAIN_K3_PER_STEP * TRAIN_STEPS}):
            problems.append(f"train rank {r}: losses {loss_err:.3e}, rows {emb_err:.3e}, "
                            f"factors {fac_err:.3e}, K3 {k3}")
    t0, t1 = ranks_train
    if not (np.array_equal(t0[1], t1[1]) and all(
            np.array_equal(t0[3][k][n], t1[3][k][n]) for k in keys for n in "ab")):
        problems.append("train: the ranks' trained rows or gathered factors differ")
    return problems, out


# -- the last modes under spatial sharding ------------------------------------------

# LCM, the T2I-Adapter, the IP-Adapter plus, the hires fix (512², then 1024²
# at strength 0.7, latent upscale) and the SDXL ensemble (1024², the base to
# this fraction, the refiner from its latents), each at 1 sample, 4 steps
SPATIAL_MODES = ("lcm", "t2i-adapter", "ip-adapter plus", "hires", "sdxl ensemble")
XL_ENSEMBLE_AT = 0.8
HIRES_STRENGTH = 0.7


def spatial_modes(mesh, steps):
    """Each of SPATIAL_MODES once with ``sharding="spatial"`` on ``mesh``
    (None: the same calls in one process), on synthetic weights from fixed
    seeds, every counter zeroed before each model's call and read after it:
    {mode: {"latents", "images", "launches" {model: K1-K5}, "shapes" {model:
    {kernel: {Lq: calls}}}, "collectives" {model: {kind: n}}, "ms" {model:
    denoise ms a visit of its last call}, "wall" s, "peak" GiB}}. The final
    latents come from a callback at each pass's last visit (the ensemble's:
    the base's ``return_latents``); each mode's pipelines are freed before
    the next mode's are built."""
    import dataclasses

    import torch

    from pww_tpu_torch.config import CLIPVisionConfig, SDModelConfig
    from pww_tpu_torch.models.clip_vision import CLIPVisionEncoder
    from pww_tpu_torch.parallel import mesh as pmesh
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.schedulers.schedules import t_start_from_strength
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params, synthetic_state

    kw = dict(mesh_kwargs(steps), num_samples=1, output_type="np",
              **({} if mesh is None else dict(sharding="spatial")))
    counters = launch_counters()
    out = {mode: {} for mode in SPATIAL_MODES}

    def run(mode, parts):
        """``parts``: (model, pipeline, visits of its last generate, call of
        the previous part's result), run in order; returns the last result."""
        res = out[mode]
        res.update(launches={}, shapes={}, collectives={}, ms={}, visits={})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0, value = time.perf_counter(), None
        for model, pipe, visits, call in parts:
            for c in counters:
                c.launches = 0
            pmesh.COLLECTIVES.clear()
            with KernelShapes() as ks:
                value = call(value)
            torch.cuda.synchronize()
            res["launches"][model] = tuple(c.launches for c in counters)
            res["shapes"][model] = {n: ks.of(n) for n in KernelShapes.NAMES}
            res["collectives"][model] = dict(pmesh.COLLECTIVES)
            res["ms"][model] = pipe.timings["denoise"] / visits * 1e3
            res["visits"][model] = visits
        res["wall"] = time.perf_counter() - t0
        res["peak"] = torch.cuda.max_memory_allocated() / 2**30
        return value

    def final_latents(mode):
        """generate's callback at each pass's last visit: the latents kept."""
        def callback(i, t, x):
            out[mode]["latents"] = x.float().cpu().numpy()
        return dict(callback=callback, callback_steps=steps)

    base = sd15_pipeline(mesh)
    # the LCM UNet: the SD-1.5 weights (shared) and a cond_proj from a seed
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = (torch.randn((base.config.unet.block_out_channels[0], LCM_COND_DIM), generator=g,
                        device="cuda") * 0.02).to(base.dtype)
    lcm = PwwPipeline(dataclasses.replace(base.config, unet=dataclasses.replace(
        base.config.unet, time_cond_proj_dim=LCM_COND_DIM)), params={
        "unet": {**base.unet.state_dict(), "time_embedding.cond_proj.weight": cond},
        "clip": base.clip.state_dict(), "vae": base.vae.state_dict()},
        tokenizer=base.tokenizer, scheduler="lcm", device="cuda", dtype=base.dtype,
        profile=True, mesh=mesh)
    images = run("lcm", [("sd15", lcm, steps, lambda _: lcm.generate(
        **dict(kw, guidance_scale=8.0), **final_latents("lcm")))])
    out["lcm"]["images"] = images
    del lcm
    base.load_t2i_adapter(seed=3)  # phase_controlnet_variants' adapter
    out["t2i-adapter"]["images"] = run("t2i-adapter", [("sd15", base, steps, lambda _: (
        base.generate(**kw, adapter_image=edge_hint(kw["color_map_image"]),
                      **final_latents("t2i-adapter"))))])
    base.t2i_adapter = None
    hires = steps - t_start_from_strength(steps, HIRES_STRENGTH)
    out["hires"]["images"] = run("hires", [("sd15", base, hires, lambda _: base.generate_hires(
        **kw, hires_strength=HIRES_STRENGTH, upscale_mode="latent", **final_latents("hires")))])
    vcfg = CLIPVisionConfig()  # phase_adapters' plus adapter and ViT-H/14 tower
    with torch.device("meta"):
        tower = CLIPVisionEncoder(vcfg)
    base.load_ip_adapter(
        ip_adapter_file_state(base.unet, vcfg.hidden_size, seed=24, plus=(768, 4, 12, 16)),
        image_encoder=(vcfg, synthetic_state(
            tower, torch.Generator(device="cuda").manual_seed(22), base.dtype)))
    out["ip-adapter plus"]["images"] = run("ip-adapter plus", [(
        "sd15", base, steps, lambda _: base.generate(
            **kw, ip_adapter_image=reference_image(), **final_latents("ip-adapter plus")))])
    del base
    torch.cuda.empty_cache()

    def xl(cfg, seed):
        return PwwPipeline(cfg, params=synthetic_params(cfg, seed=seed, device="cuda"),
                           tokenizer=synthetic_tokenizer(49408), device="cuda",
                           dtype=torch.bfloat16, profile=True, mesh=mesh)

    xbase, xref = xl(SDModelConfig.sdxl(), 0), xl(SDModelConfig.sdxl_refiner(), 1)
    xkw = dict(kw, color_map_image=sd21_color_map(1024))
    cut = steps_at_or_above(xbase, steps, XL_ENSEMBLE_AT)
    ens = out["sdxl ensemble"]

    def base_call(_):
        ens["latents"] = xbase.generate(**xkw, denoising_end=XL_ENSEMBLE_AT,
                                        return_latents=True)
        return ens["latents"]

    ens["images"] = run("sdxl ensemble", [
        ("sdxl", xbase, cut, base_call),
        ("sdxl_refiner", xref, steps - cut, lambda lat: xref.generate(
            **xkw, init_latents=lat, denoising_start=XL_ENSEMBLE_AT))])
    del xbase, xref
    torch.cuda.empty_cache()
    return out


def steps_at_or_above(pipe, steps, frac):
    """The visits of an ``steps``-step call at or above the experts' cutoff
    ``round(T - frac·T)`` (``generate``'s ``denoising_end``)."""
    n_train = pipe.config.scheduler.num_train_timesteps
    cutoff = int(round(n_train - frac * n_train))
    return int((pipe.scheduler.set_timesteps(steps).timesteps.cpu() >= cutoff).sum())


def spatial_mode_wants(steps, cut, spatial=True):
    """{mode: {model: ((K1, ..., K5) launches, {kind: collectives})}} of
    spatial_modes' calls at dp 2 (``cut``: the ensemble base's visits;
    ``spatial=False``: the same calls in one process): the launches at the
    default config, every norm site on its kernel (every site runs on each
    rank's rows; there each GroupNorm is split K4, which these counters
    leave out); the collectives as spatial_collectives derives them, plus
    one "rows" gather for each generate's result and one for each
    callback."""
    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.schedulers.schedules import t_start_from_strength

    sd15, xl, xlr = SDModelConfig.sd15(), SDModelConfig.sdxl(), SDModelConfig.sdxl_refiner()
    hires = steps - t_start_from_strength(steps, HIRES_STRENGTH)

    def times(visit, n, norms=SD15_NORMS, decodes=1):
        k = path_launches(n, visit, norms, decodes=decodes)
        if spatial:
            k["group_norm"] = 0
        return tuple(k.values())

    one = (times(VISIT, steps), dict(spatial_collectives(sd15, steps, 1), rows=2))
    return {"lcm": {"sd15": one}, "t2i-adapter": {"sd15": one},
            "ip-adapter plus": {"sd15": one},
            "hires": {"sd15": (tuple(a + b for a, b in zip(times(VISIT, steps, decodes=0),
                                                           times(HIRES_VISIT, hires))),
                               dict(spatial_collectives(sd15, steps + hires, 1), rows=4))},
            "sdxl ensemble": {
                "sdxl": (times(SDXL_LAUNCHES_PER_VISIT["sdxl"], cut, SDXL_NORMS, 0),
                         dict(spatial_collectives(xl, cut, 0), rows=1)),
                "sdxl_refiner": (times(SDXL_LAUNCHES_PER_VISIT["sdxl_refiner"], steps - cut,
                                       SDXL_REFINER_NORMS),
                                 dict(spatial_collectives(xlr, steps - cut, 1), rows=1))}}


def check_spatial_modes(ranks, want, card, steps, launches):
    """spatial_modes on each rank against the one-process ``want``: latents
    and images within SPATIAL_TOL relative L2, finite, the ranks bit-equal,
    launches and collectives as spatial_mode_wants derives them. Adds
    {"spatial_<mode>": launches} to ``launches``; returns the problems."""
    import numpy as np

    problems = []
    cut = want["sdxl ensemble"]["visits"]["sdxl"]
    wants, ones = spatial_mode_wants(steps, cut), spatial_mode_wants(steps, cut, spatial=False)
    for mode in SPATIAL_MODES:
        ref = want[mode]
        log(f"[mesh] {mode} one process: {steps} steps, denoise ms a visit {ref['ms']}, "
            f"{ref['wall']:.2f} s, peak {ref['peak']:.2f} GiB, launches {ref['launches']} | "
            f"card: {card}")
        for model, (k, _) in ones[mode].items():
            if ref["launches"][model] != k:
                problems.append(f"{mode} one process {model}: launches "
                                f"{ref['launches'][model]} != {k}")
        per = [r[mode] for r in ranks]
        for r, res in enumerate(per):
            err_lat = rel_l2(res["latents"], ref["latents"])
            err_img = rel_l2(res["images"], ref["images"])
            log(f"[mesh] spatial {mode} dp=2 rank {r} (gloo, two ranks on one card; not a "
                f"scaling number): denoise ms a visit {res['ms']}, {res['wall']:.2f} s, peak "
                f"{res['peak']:.2f} GiB, latents rel L2 {err_lat:.3e}, image rel L2 "
                f"{err_img:.3e} (tol {SPATIAL_TOL:g}), launches {res['launches']}, by Lq "
                f"{res['shapes']}, collectives {res['collectives']} | card: {card}")
            for model, (k, coll) in wants[mode].items():
                if res["launches"][model] != k or res["collectives"][model] != coll:
                    problems.append(f"spatial {mode} rank {r} {model}: launches "
                                    f"{res['launches'][model]} != {k} or collectives "
                                    f"{res['collectives'][model]} != {coll}")
            if not (err_lat <= SPATIAL_TOL and err_img <= SPATIAL_TOL
                    and np.isfinite(res["latents"]).all()
                    and res["images"].shape == ref["images"].shape
                    and res["latents"].shape == ref["latents"].shape):
                problems.append(f"spatial {mode} rank {r}: latents rel L2 {err_lat:.3e}, "
                                f"image {res['images'].shape} rel L2 {err_img:.3e}")
        if not (np.array_equal(per[0]["latents"], per[1]["latents"])
                and np.array_equal(per[0]["images"], per[1]["images"])):
            problems.append(f"spatial {mode}: the two ranks' results differ")
        launches[f"spatial_{mode.replace(' ', '_').replace('-', '_')}"] = {
            c.__name__: sum(n[i] for n in per[0]["launches"].values())
            for i, c in enumerate(launch_counters())}
    return problems


def phase_utils(pipe, kw, card):
    """The native host library on the main path's color map against its
    numpy versions; PhaseTimer, trace and the NaN checks on the card; LPIPS
    on the card against the CPU."""
    import numpy as np
    import torch

    from pww_tpu_torch import native
    from pww_tpu_torch.metrics import lpips
    from pww_tpu_torch.native import plain
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.utils.profiling import PhaseTimer, enable_nan_checks, trace

    problems = []
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    cm = kw["color_map_image"]
    colors = np.array([(255, 0, 0), (0, 0, 255), (7, 7, 7)], np.uint8)
    strengths = np.array([0.5, 0.5, 1.0], np.float32)
    ids = pipe.tokenizer(kw["input_prompt"])["input_ids"]
    checks = {
        "color_masks": lambda m: m.color_masks(cm, colors, strengths),
        "color_mask_sqdist": lambda m: m.color_mask_sqdist(cm, (250, 3, 3), 30),
        "unique_colors": lambda m: m.unique_colors(cm, 0.01, 8),
        "token_match_row": lambda m: m.token_match_row(ids, ids[2:4]),
    }
    for name, call in checks.items():
        got, want = call(native), call(plain)
        if isinstance(got, tuple):
            same = all(np.array_equal(g, w) for g, w in zip(got, want))
        elif isinstance(got, list):  # the map's two colors tie: their order is free
            same = sorted(got) == sorted(want) and [n for _, n in got] == [n for _, n in want]
        else:
            same = np.array_equal(got, want)
        t1 = time.perf_counter()
        call(native)
        t_lib = time.perf_counter() - t1
        t1 = time.perf_counter()
        call(plain)
        t_np = time.perf_counter() - t1
        log(f"[utils] native {name} on the 512² map: equal to numpy {same}, "
            f"{t_lib * 1e3:.3f} ms (numpy {t_np * 1e3:.3f} ms, host)")
        if not same:
            problems.append(f"native {name} differs from numpy")
    log(f"[utils] native library built and loaded in {build_s:.2f} s")

    timer = PhaseTimer()
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        with timer.phase("matmul", sync=x):
            x = (x @ x).clamp_(-1, 1)
    s = timer.summary()["matmul"]
    log(f"[utils] PhaseTimer: 3 synchronised 4096² bf16 matmuls, p50 {s['p50_s'] * 1e3:.3f} ms "
        f"| card: {card}")
    if s["count"] != 3 or not s["p50_s"] > 0:
        problems.append(f"PhaseTimer {s}")

    tdir = tempfile.mkdtemp(prefix="pww_trace_")
    try:
        with trace(tdir):
            paint_with_words(num_inference_steps=2, **kw)
        path = os.path.join(tdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        pww = sum("pww" in e.get("name", "") or "flash" in e.get("name", "") for e in kernels)
        log(f"[utils] trace: {os.path.getsize(path)} bytes, {len(events)} events, "
            f"{len(kernels)} device kernels ({pww} of K1-K3) in a 2-step call")
        if not kernels or not pww:
            problems.append("the trace holds no device kernels of the port")
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

    bad = torch.zeros(1, 4, 64, 64, device="cuda", dtype=torch.bfloat16)
    bad[0, 0, 3, 3] = float("nan")
    enable_nan_checks(True)
    try:
        pipe.unet.conv_in(bad)
        caught = None
    except FloatingPointError as e:
        caught = str(e)
    finally:
        enable_nan_checks(False)
    log(f"[utils] enable_nan_checks on a planted NaN: {caught!r}")
    if caught is None or "Conv2d" not in caught:
        problems.append("enable_nan_checks missed a planted NaN")

    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    gpu_params = lpips.init_random_lpips(0, device="cuda")
    got = lpips.lpips_distance(gpu_params, a, b).cpu().numpy()
    want = lpips.lpips_distance(lpips.init_random_lpips(0, device="cpu"), a, b).numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ms = time_ms(lambda: lpips.lpips_distance(gpu_params, a, b), reps=5, trials=3, warmup=1)
    log(f"[utils] lpips_distance (random weights, not a calibrated metric) on 2 × 256²: card "
        f"{got.tolist()} vs CPU {want.tolist()}, rel {rel:.2e} (tol 1e-4), {ms:.3f} ms "
        f"(host arrays in) | card: {card}")
    if rel > 1e-4:
        problems.append(f"lpips card vs CPU rel {rel:.2e}")
    if problems:
        raise SystemExit(f"[utils] {problems}")


# Rows of a served group against the same requests through generate alone:
# relative L2 of the f32 images, a bound on what bf16 rounding of the 16-row
# products leaves (the reading is about 6e-4). With synthetic weights the
# text states barely vary across tokens, so a row-order fault moves the
# output no more than that rounding does; the fault is caught where it is
# made, in the denoise inputs, which must equal the request's alone bit for
# bit (the phase plants the fault and shows both).
SERVE_IMAGE_TOL = 5e-3


def serve_requests(steps, tag="", n=8):
    """``n`` paint-with-words requests on one 512² grid: distinct prompts and
    seeds, and the cat/dog map with its split and colors moved per request."""
    import numpy as np

    palette = [(255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 255, 0), (255, 0, 255),
               (0, 255, 255), (255, 128, 0), (128, 0, 255)]
    reqs = []
    for i in range(n):
        j = i % 8
        left, right = palette[j], palette[(j + 3) % 8]
        cut = 128 + 32 * j + 16 * (i // 8)
        cm = np.zeros((512, 512, 3), np.uint8)
        cm[:, :cut] = left
        cm[:, cut:] = right
        if i % 2:  # the regions side by side the other way round
            cm = np.ascontiguousarray(cm[:, ::-1])
        reqs.append(dict(
            prompt=f"{tag}a cat sitting next to a dog, realistic photo, take {i}",
            color_map_image=cm, seed=100 + i, num_inference_steps=steps,
            guidance_scale=7.5,
            color_context={left: f"cat,{0.3 + 0.05 * j:g}", right: f"dog,{0.6 - 0.05 * j:g}"}))
    return reqs


def rolled_layouts(denoise):
    """A planted row-order fault around ``denoise``: within each CFG half,
    request i gets request i-1's PwW weights (its neighbour's layout)."""
    import dataclasses

    import torch

    def roll(x):
        return torch.cat([torch.roll(half, 1, 0) for half in x.chunk(2)])

    def faulty(lat, text_states, pww, *args, **kwargs):
        pww = dataclasses.replace(pww, weights={k: roll(v) for k, v in pww.weights.items()},
                                  weight_orig=roll(pww.weight_orig))
        return denoise(lat, text_states, pww, *args, **kwargs)

    return faulty


def denoise_inputs_of(seen, row):
    """One request's row of a captured denoise call: its initial latents,
    and its uncond and cond text states and PwW weight pyramid (the
    full-resolution map, 1.3 GB at 16 rows, is left out: every site of a
    512² call has its pyramid level)."""
    n = seen["lat"].shape[0]
    pick = [row, n + row]
    return {"latents": seen["lat"][row:row + 1], "text": seen["text"][pick],
            **{f"weights {k}": w[pick] for k, w in seen["weights"].items()}}


def phase_serve(pipe, steps):
    """The serving path on the main pipeline, without per-phase syncs: a
    Batcher over 16 concurrent requests forms two groups of 8, and the second
    launches while the first's fetch is held back; rows of both groups
    against generate alone, in their denoise inputs and their images, and a
    planted row-order fault that the inputs' check must catch; then a 5-step
    profile, a two-window long prompt, and one POST /generate."""
    import threading

    import numpy as np
    import torch

    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.conditioning.encode import _window_ids
    from pww_tpu_torch.serving.batcher import Batcher

    problems = []
    # warm-up on other prompts (cuDNN plans and the allocator at 16 rows);
    # the served run below encodes its own prompts in one text-encoder call
    # per group
    pipe.generate_batch(serve_requests(2, "warm-up "), num_inference_steps=2, output_type="np")
    reqs = serve_requests(steps, n=16)
    index = {id(r): i for i, r in enumerate(reqs)}
    counters = launch_counters()
    finite = []  # one device flag per group, read after the run: no sync
    groups = []  # per generate_batch call: (request indices, launches, host s)
    inputs = []  # per denoise call: its latents, text states and PwW weights
    second_launched = threading.Event()
    batch, decode, denoise = pipe.generate_batch, pipe.decode_uint8_device, pipe.denoise

    def counted_batch(requests, **kwargs):
        before = {c.__name__: c.launches for c in counters}
        t = time.perf_counter()
        out = batch(requests, **kwargs)
        groups.append(([index[id(r)] for r in requests],
                       {c.__name__: c.launches - before[c.__name__] for c in counters},
                       time.perf_counter() - t))
        if len(groups) == 2:
            second_launched.set()
        return out

    def checked_decode(lat, *args):
        finite.append(torch.isfinite(lat).all())
        return decode(lat, *args)

    def captured_denoise(lat, text_states, pww, *args, **kwargs):
        inputs.append(dict(lat=lat.clone(), text=text_states, weights=pww.weights))
        return denoise(lat, text_states, pww, *args, **kwargs)

    pipe.generate_batch, pipe.decode_uint8_device = counted_batch, checked_decode
    pipe.denoise = captured_denoise
    pipe.profile = False
    batcher = Batcher(pipe, max_batch=8, max_wait_ms=2000.0)
    to_host, held = batcher._to_host, []

    def held_to_host(launch):
        # the first group's fetch waits until the second group has launched:
        # a launch that waited on a fetch would stall here and fail the gate
        if not held:
            held.append(second_launched.wait(timeout=300))
        return to_host(launch)

    batcher._to_host = held_to_host
    futures = [None] * 16
    gate = threading.Barrier(16)

    def client(i):
        gate.wait()
        futures[i] = batcher.submit(reqs[i])

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        images = [np.asarray(f.result(timeout=600)) for f in futures]
        wall = time.perf_counter() - t0
    finally:
        batcher.close()
        del pipe.generate_batch, pipe.decode_uint8_device
        pipe.profile = True
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = dict(batcher.stats)
    finite = [bool(f) for f in finite]
    log(f"[serve] Batcher(max_batch=8), no per-phase syncs: 16 concurrent requests, 512², "
        f"{steps} LMS steps, CFG 7.5: {wall:.3f} s wall, {wall / 16:.4f} s/image, peak "
        f"{peak:.2f} GiB; stats {stats}; host s per generate_batch call "
        f"{[round(g[2], 3) for g in groups]}; first fetch held until the second launch: "
        f"{held}")
    log(f"[serve] launches: {launches}; per group {[g[1] for g in groups]}")
    # every norm site on K4 / K5, at SERVE_K4_SITES' and SERVE_K5_SITES'
    # signatures, which phase 3 times
    want = path_launches(steps)
    if stats["batches"] != 2 or stats["batched_requests"] != 16:
        problems.append(f"not two groups: {stats}")
    if (len(groups) != 2 or len(inputs) != 2 or any(len(g[0]) != 8 for g in groups)
            or sorted(groups[0][0] + groups[1][0]) != list(range(16))):
        problems.append(f"groups {[g[0] for g in groups]}, {len(inputs)} denoise calls")
    if any(g[1] != want for g in groups) or launches != {k: 2 * v for k, v in want.items()}:
        problems.append(f"launches {launches}, per group {[g[1] for g in groups]}, "
                        f"{want} per group wanted")
    if held != [True]:
        problems.append("the second group did not launch while the first's fetch was held")
    if finite != [True, True] or any(im.shape != (512, 512, 3) for im in images):
        problems.append(f"latents finite {finite}, shapes {[im.shape for im in images]}")
    same = [(i, j) for i in range(16) for j in range(i + 1, 16)
            if np.array_equal(images[i], images[j])]
    if same or any(im.std() == 0 for im in images):
        problems.append(f"equal images {same} or a constant one")
    if problems:
        del pipe.denoise
        raise SystemExit(f"[serve] {problems}")

    def rel_l2(got, want):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def differing(got, want):  # the denoise inputs that are not bit-equal
        return [k for k in want if not torch.equal(got[k], want[k])]

    # rows against the same requests served alone: the same denoise inputs,
    # bit for bit (cached text states and weights, per-request noise); the
    # images differ only by the rounding of the 16-row products
    first = groups[0][0]
    alone = {}  # request → (its image alone, its denoise inputs alone)
    try:
        for g, row in ((0, 0), (0, 7), (1, 0), (1, 7)):
            i = groups[g][0][row]
            image = pipe.generate(**reqs[i], output_type="np")[0]
            alone[i] = image, denoise_inputs_of(inputs[-1], 0)
            bad = differing(denoise_inputs_of(inputs[g], row), alone[i][1])
            rel = rel_l2(images[i], image)
            ok = not bad and rel < SERVE_IMAGE_TOL
            log(f"[serve] request {i} (group {g + 1}, row {row}) vs generate alone: denoise "
                f"inputs {'bit-equal' if not bad else f'DIFFER in {bad}'} "
                f"({len(alone[i][1])} tensors), image relative L2 {rel:.3e} (tol "
                f"{SERVE_IMAGE_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                problems.append(f"request {i}: inputs differ in {bad}, image {rel:.3e}")
        # the fault the check must catch: the first group again, each request
        # given its neighbour's layout
        pipe.denoise = rolled_layouts(captured_denoise)
        faulty = pipe.generate_batch([reqs[i] for i in first], num_inference_steps=steps,
                                     output_type="np")
    finally:
        del pipe.denoise
    for row in (0, 7):
        i = first[row]
        bad = differing(denoise_inputs_of(inputs[-1], row), alone[i][1])
        rel = rel_l2(faulty[row], alone[i][0])
        log(f"[serve] planted fault, layouts rolled by one: request {i} vs generate alone: "
            f"denoise inputs differ in {len(bad)} of {len(alone[i][1])} tensors "
            f"({'caught' if bad else 'NOT caught'}), image relative L2 {rel:.3e}")
        if not bad:
            problems.append(f"planted fault not caught for request {i}")
    if problems:
        raise SystemExit(f"[serve] {problems}")
    # the per-phase split of one group's call, synchronised (the encode hits
    # the text cache the served run filled)
    pipe.generate_batch([reqs[i] for i in first], num_inference_steps=steps, output_type="np")
    tm = pipe.timings
    log(f"[serve] one generate_batch of group 1, synchronised per phase: encode "
        f"{tm['encode']:.3f} s (cached), denoise {tm['denoise']:.3f} s "
        f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s")
    profiled = phase_profile(
        lambda n: pipe.generate_batch(reqs[:8], num_inference_steps=n, output_type="np"),
        "serve")
    if profiled["K1 pww_reduce"][1] != 1:
        raise SystemExit("[profile serve] K1 is not one device kernel per call")
    phase_long_prompt(pipe, reqs[0], steps, unet_mod, _window_ids)
    phase_http(pipe, reqs[1], steps)
    return launches, profiled


def phase_long_prompt(pipe, req, steps, unet_mod, window_ids):
    """One full-width generate with a two-window prompt: K1 and K2 at Lk 154."""
    import torch

    prompt = req["prompt"]
    while len(window_ids(pipe.tokenizer, prompt, 77)) < 2:
        prompt += ", soft light on the fur"
    seen = {"fused_pww_reduce": set(), "fused_pww_cross_attention": set()}
    originals = {n: getattr(unet_mod, n) for n in seen}

    def recorded(name):
        def call(q, k, *args):
            seen[name].add(k.shape[2])
            return originals[name](q, k, *args)
        return call

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    for n in seen:
        setattr(unet_mod, n, recorded(n))
    try:
        img = pipe.generate(**dict(req, prompt=prompt), long_prompts=True, output_type="np")
        torch.cuda.synchronize()
    finally:
        for n, fn in originals.items():
            setattr(unet_mod, n, fn)
    launches = {c.__name__: c.launches for c in counters}
    log(f"[long prompt] {len(window_ids(pipe.tokenizer, prompt, 77))} windows, "
        f"{steps} steps: text keys {seen}, launches {launches}, image mean "
        f"{img.mean():.2f} std {img.std():.2f}")
    want = path_launches(steps)
    if (launches != want or seen != {n: {154} for n in seen} or img.std() == 0):
        raise SystemExit(f"[long prompt] launches {launches} != {want}, text keys {seen}, "
                         f"or a constant image")


def phase_http(pipe, req, steps):
    """One POST /generate to the server's handler on a localhost server; the
    PNG must equal the same request through generate."""
    import base64
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from pww_tpu_torch.serving.batcher import Batcher
    from pww_tpu_torch.serving.server import make_handler

    buf = io.BytesIO()
    Image.fromarray(req["color_map_image"]).save(buf, format="PNG")
    body = {"prompt": req["prompt"], "seed": req["seed"], "steps": steps,
            "guidance_scale": req["guidance_scale"],
            "color_context": {str(k): v for k, v in req["color_context"].items()},
            "color_map_png_b64": base64.b64encode(buf.getvalue()).decode()}
    batcher = Batcher(pipe, max_batch=8, max_wait_ms=25.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        post = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(post, timeout=600) as r:
            out = json.loads(r.read())
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        batcher.close()
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"]))))
    want = pipe.generate(**req, output_type="np")[0]
    same = got.shape == want.shape and np.array_equal(got, want)
    log(f"[http] POST /generate 512², {steps} steps: {wall:.3f} s round trip, latency_s "
        f"{out['latency_s']}, PNG {got.shape} {'equals' if same else 'DIFFERS from'} "
        f"generate; /metrics {metrics}")
    if not same:
        raise SystemExit("[http] the served image differs from generate's")


# -- the sampling extras (ROADMAP A.14) ------------------------------------------------

# Launches of K1 / K2 / K3 per UNet visit at SD-1.5's 512² (15 / 15 / 10), of
# DeepCache's shallow visit (down block 0 and the last up block: 5 / 5 / 5),
# of SAG's visit (the batched pass and the uncond pass on the degraded
# latents: 30 / 30 / 20), and of a visit at 1024², the hires fix's second
# pass (the 16² mid block reaches Lq 256 for K1 / K2, and the 32² sites L
# 1024 for K3: 16 / 16 / 15)
VISIT = (15, 15, 10)
SHALLOW_VISIT = (5, 5, 5)
SAG_VISIT = (30, 30, 20)
HIRES_VISIT = (16, 16, 15)
LCM_COND_DIM = 256  # SimianLuo/LCM_Dreamshaper_v7 unet/config.json time_cond_proj_dim
# K4 / K5 launches at the default config on the card, where every norm site
# takes its kernel (bf16, no gradient recorded): each GroupNorm and
# LayerNorm module runs once a forward, so the models' counts give (K4 a
# UNet visit, K5 a UNet visit, K4 a VAE encode, K4 a VAE decode)
# (tests/test_torch_norm_sites.py counts them); a ControlNet adds its
# (K4, K5) to each visit; DeepCache's shallow visit runs down block 0, the
# last up block and conv_norm_out
SD15_NORMS = (61, 48, 22, 30)  # SD-2.1's too
SDXL_NORMS = (46, 210, 22, 30)
SDXL_REFINER_NORMS = (56, 132, 22, 30)
TINY_NORMS = (21, 12, 14, 22)
CONTROLNET_NORMS = (27, 21)  # SD-1.5's ControlNet
SDXL_CONTROLNET_NORMS = (21, 102)
SHALLOW_NORMS = (16, 15)


def path_launches(steps, visit=VISIT, norms=SD15_NORMS, encodes=0, decodes=1, net=(0, 0)):
    """K1-K5 launches at the default config on the card of a call with
    ``steps`` UNet visits of ``visit`` K1/K2/K3 launches each, a ControlNet
    adding ``net`` K4/K5 to each, ``encodes`` VAE encodes and ``decodes``
    decodes."""
    return {"fused_pww_reduce": visit[0] * steps, "fused_pww_cross_attention": visit[1] * steps,
            "flash_self_attention": visit[2] * steps,
            "group_norm": (norms[0] + net[0]) * steps + norms[2] * encodes + norms[3] * decodes,
            "layer_norm": (norms[1] + net[1]) * steps}


def deepcache_launches(steps, interval):
    full = -(-steps // interval)
    return tuple(f * full + s * (steps - full) for f, s in zip(VISIT, SHALLOW_VISIT))


class EagerLoop:
    """The denoise loop eagerly while active (``graphs.engages`` reads
    false): for the checks that spy on the kernel wrappers' Python calls,
    which a replayed CUDA graph does not make, or that read a tensor back
    to the host from inside a visit, which a capture refuses. phase_graphs
    holds the replays against this loop."""

    def __enter__(self):
        from pww_tpu_torch.pipeline import graphs

        self.graphs, self.engages = graphs, graphs.engages
        graphs.engages = lambda device, **kw: False
        return self

    def __exit__(self, *exc):
        self.graphs.engages = self.engages


class KernelShapes(EagerLoop):
    """Counts K1 / K2 / K3 calls by sequence length while active: wraps the
    UNet module's names for the three wrappers (the wrappers count their
    own launches as before), on the eager loop (:class:`EagerLoop`)."""

    NAMES = ("fused_pww_reduce", "fused_pww_cross_attention", "flash_self_attention")

    def __init__(self):
        import collections

        import pww_tpu_torch.models.unet as unet_mod

        self.mod, self.seen = unet_mod, collections.Counter()
        self.originals = {n: getattr(unet_mod, n) for n in self.NAMES}

    def __enter__(self):
        def wrap(name, fn):
            def call(q, *args):
                self.seen[name, q.shape[2]] += 1
                return fn(q, *args)
            return call

        for n, fn in self.originals.items():
            setattr(self.mod, n, wrap(n, fn))
        return super().__enter__()

    def __exit__(self, *exc):
        for n, fn in self.originals.items():
            setattr(self.mod, n, fn)
        super().__exit__(*exc)

    def of(self, name):
        return {l: c for (n, l), c in sorted(self.seen.items()) if n == name}


GRAPH_STEPS = 6  # a group of the graphs phase: an eager visit, a capture, four replays
CHECK_LIMITS = {"sd15": 0.12, "sdxl": 0.1}  # portbench/cells/*.json image_rel_l2


def graph_lora(pipe, scale=0.02, rank=4):
    """A rank-``rank`` kohya LoRA on every ``attn2.to_k`` of the UNet, its
    halves N(0, scale²) from a seed."""
    import torch

    g = torch.Generator(device=pipe.device).manual_seed(7)
    state = {}
    for name, w in pipe.unet.state_dict().items():
        if name.endswith("attn2.to_k.weight"):
            prefix = "lora_unet_" + name[:-len(".weight")].replace(".", "_")
            state[f"{prefix}.lora_down.weight"] = scale * torch.randn(
                (rank, w.shape[1]), generator=g, device=pipe.device)
            state[f"{prefix}.lora_up.weight"] = scale * torch.randn(
                (w.shape[0], rank), generator=g, device=pipe.device)
    return state


class VisitOutputs:
    """The f32 output of every UNet visit while active, in order: from the
    graph sessions where the loop replays (``graphed``), else from the
    UNet's forward."""

    def __init__(self, pipe, graphed):
        self.pipe, self.graphed, self.outs = pipe, graphed, []

    def __enter__(self):
        from pww_tpu_torch.pipeline import graphs

        if self.graphed:
            self.visit = visit = graphs.Session.visit

            def recorded(session, inputs):
                out = visit(session, inputs)
                self.outs.append(out.clone())
                return out

            graphs.Session.visit = recorded
        else:
            self.hook = self.pipe.unet.register_forward_hook(
                lambda module, args, out: self.outs.append(out.float()))
        return self

    def __exit__(self, *exc):
        from pww_tpu_torch.pipeline import graphs

        if self.graphed:
            graphs.Session.visit = self.visit
        else:
            self.hook.remove()


def graph_groups(pipe, groups, lora, steps, graphed):
    """groups[0] on the pipeline's weights, groups[1] with ``lora`` merged,
    groups[2] and groups[3] after the restore, through the CUDA graphs
    (``graphed``) or the eager loop. Per group: its uint8 images, its UNet
    visits' f32 outputs, its K1-K5 launches and the pipeline's visit counts
    (eager, captured, replayed); and each capture's (s, GB of memory the
    card's allocator reserved for it)."""
    import torch

    from pww_tpu_torch.pipeline import graphs

    counters = launch_counters()
    rule, new = graphs.engages, graphs.VisitGraphs._new
    captures = []

    def timed_new(self, *args):
        torch.cuda.synchronize()
        reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
        entry = new(self, *args)
        torch.cuda.synchronize()
        captures.append((time.perf_counter() - t0,
                         (torch.cuda.memory_reserved() - reserved) / 1e9))
        return entry

    graphs.VisitGraphs._new = timed_new
    if not graphed:
        graphs.engages = lambda device, **kw: False
    out = []
    try:
        for i, reqs in enumerate(groups):
            if i == 1:
                pipe.load_lora(lora)
            elif i == 2:
                pipe.unload_loras()
            for c in counters:
                c.launches = 0
            before = dict(pipe.unet_graphs.counts)
            with VisitOutputs(pipe, graphed) as rec:
                images = pipe.generate_batch(reqs, num_inference_steps=steps, output_type="np")
            torch.cuda.synchronize()
            out.append((images, rec.outs, {c.__name__: c.launches for c in counters},
                        {k: v - before[k] for k, v in pipe.unet_graphs.counts.items()}))
    finally:
        graphs.engages, graphs.VisitGraphs._new = rule, new
    return out, captures


def check_graph_groups(pipe, tag, family, groups, steps, visit, norms, problems):
    """Four groups on the CUDA graphs, then the same on the eager loop (a
    LoRA merged for the second, restored after it): the UNet's outputs
    visit by visit and the uint8 images, identical or within the cell's
    check limit; K1-K5 launches of the table, on both paths; the captures'
    s and reserved GB; peak memory on each path."""
    import numpy as np
    import torch

    lora = graph_lora(pipe)
    runs = {}
    for graphed in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[graphed] = graph_groups(pipe, groups, lora, steps, graphed)
        peak = (torch.cuda.max_memory_allocated() / 1e9, torch.cuda.max_memory_reserved() / 1e9)
        log(f"[graphs] {tag}, {'graphs' if graphed else 'eager'}: 4 groups of "
            f"{len(groups[0])} in {time.perf_counter() - t0:.2f} s, peak {peak[0]:.2f} GB "
            f"allocated, {peak[1]:.2f} GB reserved")
    (got, captures), (want, _) = runs[True], runs[False]
    log(f"[graphs] {tag}: {len(captures)} captures, " + ", ".join(
        f"{s * 1e3:.0f} ms (+{gb:.2f} GB reserved)" for s, gb in captures))
    table = path_launches(steps, visit, norms)
    for i, ((gi, go, gl, gc), (ei, eo, el, _)) in enumerate(zip(got, want)):
        diffs = [float((a - b).abs().max()) for a, b in zip(go, eo)]
        same = len(go) == len(eo) == steps and not any(diffs)
        pixels = int(np.abs(gi.astype(np.int32) - ei.astype(np.int32)).max())
        rel = rel_l2(gi / 127.5 - 1.0, ei / 127.5 - 1.0)
        images = "identical" if pixels == 0 else f"differ by up to {pixels} levels"
        log(f"[graphs] {tag} group {i}: visits {gc}; UNet outputs "
            f"{'identical' if same else f'differ, largest {max(diffs or [0.0]):.3e}'} over "
            f"{len(go)} visits; images {images}, image_rel_l2 {rel:.3e}; launches {gl}, "
            "per visit "
            + ", ".join(f"{k} {(gl[k] - (norms[3] if k == 'group_norm' else 0)) / steps:g}"
                        for k in gl))
        if gl != table or el != table:
            problems.append(f"{tag} group {i}: launches {gl} (graphs), {el} (eager) != {table}")
        if len(go) != steps or rel > CHECK_LIMITS[family] or not np.isfinite(rel):
            problems.append(f"{tag} group {i}: {len(go)} visits, image_rel_l2 {rel}")
        if gc["replayed"] + gc["captured"] + gc["eager"] != steps or (
                i == 3 and gc["replayed"] != steps):
            problems.append(f"{tag} group {i}: visit counts {gc}")
    if len(captures) != 3:
        problems.append(f"{tag}: {len(captures)} captures, not one a weight generation")


def graph_call_vs_eager(call, tag, problems, limit):
    """``call()`` on the graphs twice (the first captures), then on the
    eager loop twice: wall ms of each, and the images against the eager
    loop's."""
    import numpy as np
    import torch

    from pww_tpu_torch.pipeline import graphs

    rule, walls, images = graphs.engages, [], []
    try:
        for graphed in (True, True, False, False):
            graphs.engages = rule if graphed else (lambda device, **kw: False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images.append(call())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        graphs.engages = rule
    pixels = int(np.abs(images[0].astype(np.int32) - images[2].astype(np.int32)).max())
    rel = rel_l2(images[1] / 127.5 - 1.0, images[2] / 127.5 - 1.0)
    log(f"[graphs] {tag}: wall ms graphs (first call, with the capture) {walls[0] * 1e3:.1f}, "
        f"graphs {walls[1] * 1e3:.1f}; eager {walls[2] * 1e3:.1f}, {walls[3] * 1e3:.1f}; "
        f"images {'identical' if pixels == 0 else f'differ by up to {pixels} levels'}, "
        f"image_rel_l2 {rel:.3e}")
    if rel > limit or not np.isfinite(rel) or not np.array_equal(images[0], images[1]):
        problems.append(f"{tag}: image_rel_l2 {rel}, or two graph calls disagree")


def xl_requests(n):
    """``serve_requests``' maps at 1024²."""
    import numpy as np

    return [dict(r, color_map_image=np.repeat(np.repeat(r["color_map_image"], 2, 0), 2, 1))
            for r in serve_requests(GRAPH_STEPS, n=n)]


def phase_graphs(card):
    """The UNet visits replayed from CUDA graphs (pipeline/graphs.py)
    against the eager loop at the served signatures: SD-1.5 at 16 CFG rows
    512² and SDXL-base at 8 rows 1024², four groups each with a LoRA merged
    for the second; LCM-4 and the hires fix at batch 1 on SD-1.5; the
    replays' K1-K4 device kernels in a torch.profiler trace, one a wrapper
    call."""
    import dataclasses
    import gc

    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    t_start, problems = time.perf_counter(), []
    sd15 = sd15_pipeline(profile=False)
    reqs = serve_requests(GRAPH_STEPS, n=32)
    groups = [reqs[8 * i:8 * i + 8] for i in range(4)]
    check_graph_groups(sd15, "sd15 16 rows 512²", "sd15", groups, GRAPH_STEPS, VISIT,
                       SD15_NORMS, problems)
    # the eager run's LoRA merge and restore dropped the graphs: capture again
    sd15.generate_batch(groups[3], num_inference_steps=2, output_type="np")
    before = dict(sd15.unet_graphs.counts)
    profiled = phase_profile(lambda n: sd15.generate_batch(
        groups[3], num_inference_steps=n, output_type="np"), "graphs replay")
    replays = sd15.unet_graphs.counts["replayed"] - before["replayed"]
    for group in ("K1 pww_reduce", "K2 pww_cross_attention", "K3 flash_self_attention",
                  "K4 group_norm"):
        if profiled.get(group, (0, 0))[1] != 1:
            problems.append(f"profile: {group} {profiled.get(group)} device kernels per "
                            "wrapper call under replay")
    if replays != 5:  # phase_profile's 5-step call, every visit a replay
        problems.append(f"profile: {replays} of 5 visits replayed")
    one = {k: v for k, v in groups[0][0].items() if k not in ("num_inference_steps",
                                                              "guidance_scale")}
    graph_call_vs_eager(lambda: sd15.generate_hires(
        **one, num_inference_steps=4, hires_strength=0.7, output_type="np"),
        "hires fix 512² → 1024², 4 steps", problems, CHECK_LIMITS["sd15"])
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = (torch.randn((sd15.config.unet.block_out_channels[0], LCM_COND_DIM), generator=g,
                        device="cuda") * 0.02).to(sd15.dtype)
    lcm = PwwPipeline(dataclasses.replace(sd15.config, unet=dataclasses.replace(
        sd15.config.unet, time_cond_proj_dim=LCM_COND_DIM)), params={
        "unet": {**sd15.unet.state_dict(), "time_embedding.cond_proj.weight": cond},
        "clip": sd15.clip.state_dict(), "vae": sd15.vae.state_dict()},
        tokenizer=sd15.tokenizer, scheduler="lcm", device="cuda", dtype=sd15.dtype)
    graph_call_vs_eager(lambda: lcm.generate(**one, num_inference_steps=4, guidance_scale=8.0,
                                             output_type="np"),
                        "LCM-4 batch 1 512²", problems, CHECK_LIMITS["sd15"])
    del sd15, lcm
    gc.collect()
    torch.cuda.empty_cache()
    cfg = SDModelConfig.sdxl()
    t0 = time.perf_counter()
    xl = PwwPipeline(cfg, params=synthetic_params(cfg, seed=0, device="cuda",
                                                  dtype=torch.bfloat16),
                     tokenizer=synthetic_tokenizer(49408), device="cuda", dtype=torch.bfloat16)
    log(f"[graphs] SDXL-base on the card in {time.perf_counter() - t0:.1f} s")
    reqs = xl_requests(16)
    check_graph_groups(xl, "sdxl 8 rows 1024²", "sdxl", [reqs[4 * i:4 * i + 4] for i in range(4)],
                       GRAPH_STEPS, SDXL_LAUNCHES_PER_VISIT["sdxl"], SDXL_NORMS, problems)
    del xl
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[graphs] {time.perf_counter() - t_start:.1f} s on {card}")
    if problems:
        raise SystemExit("[graphs] " + "; ".join(problems))


def rel_l2(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def reduced_sd15(seed=1, **unet_kw):
    """phase_reference's reduced-depth SD-1.5-width config (UNet (320, 640),
    one layer a block, the tiny text tower and VAE) and its weights, std 0.1,
    on the card in f32 and on the CPU."""
    import dataclasses

    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.weights.bridge import synthetic_params

    clip = CLIPTextConfig.tiny()
    unet = UNetConfig(block_out_channels=(320, 640), layers_per_block=1,
                      down_block_has_attn=(True, False), cross_attention_dim=clip.hidden_size)
    cfg = SDModelConfig(clip=clip, unet=dataclasses.replace(unet, **unet_kw),
                        vae=VAEConfig.tiny())
    # std 0.1 rather than 0.02, so that three steps move the latents well
    # away from the initial noise and the comparison sees the UNet's output
    params = synthetic_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    return cfg, params, cpu


def cat_dog_map(size):
    import numpy as np

    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, :size // 2] = (255, 0, 0)
    cm[:, size // 2:] = (0, 0, 255)
    return cm


# Card bf16 against CPU f32 on the reduced config, relative L2 of the final
# latents (images for the hires fix): 5e-2 as phase_reference, where the
# extra changes only the arithmetic. ToMe 1e-1: the card's matching runs on
# the bf16 block input, so a src token whose two best similarities lie
# within bf16 rounding can merge into another dst than on the CPU (the
# phase counts those tokens at the first site); SAG 1e-1: a key whose
# attention received lies within rounding of the 1.0 cut flips its mask
# bit, which moves the blur over a 2×2 latent patch (the phase counts the
# flipped keys at the first visit).
EXTRAS_REF_TOL = {"DeepCache 2": 5e-2, "ToMe 0.5": 1e-1, "FreeU": 5e-2, "SAG 0.75": 1e-1,
                  "prompt editing": 5e-2, "LCM 4-step": 5e-2, "hires latent": 5e-2}


def phase_extras_reference():
    """Each extra on the reduced-depth config, card bf16 against CPU f32:
    256 px, 3 LMS steps (ToMe at 512 px, whose 64² sites merge to L 2048 and
    take K3; the hires fix 256 → 512 px); K1-K3 must launch on the card."""
    import numpy as np
    import torch

    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline, sag_mask

    results, failed = {}, []
    counters = launch_counters()[:3]

    def compare(name, gpu_pipe, cpu_pipe, call):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        gpu = call(gpu_pipe)
        launched = tuple(c.launches for c in counters)
        t1 = time.perf_counter()
        ref = call(cpu_pipe)
        t2 = time.perf_counter()
        rel, tol = rel_l2(gpu, ref), EXTRAS_REF_TOL[name]
        ok = bool(np.isfinite(np.asarray(gpu, np.float32)).all()) and rel < tol and min(launched)
        results[name] = rel
        log(f"[extras reference] {name}: card bf16 vs CPU f32 relative L2 {rel:.3e} (tol "
            f"{tol:g}), K1/K2/K3 launches {launched}, card {t1 - t0:.1f} s, CPU "
            f"{t2 - t1:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)

    cfg, params, cpu = reduced_sd15()
    gpu_pipe = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16)
    cpu_pipe = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32)
    del params, cpu
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cat_dog_map(256),
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True)
    compare("DeepCache 2", gpu_pipe, cpu_pipe, lambda p: p.generate(**kw, cache_interval=2))
    compare("FreeU", gpu_pipe, cpu_pipe, lambda p: p.generate(**kw, freeu=True))
    compare("prompt editing", gpu_pipe, cpu_pipe, lambda p: p.generate(
        **dict(kw, prompt="a [cat:fox:0.5] sitting next to a dog"), prompt_editing=True))

    masks = {}  # SAG: each run's mask at the first visit
    real_sag = PwwPipeline._sag_degraded_eps

    def sag_spy(self, lat, eps_u, probs_u, *args):
        masks.setdefault(self.device.type, sag_mask(probs_u).cpu())
        return real_sag(self, lat, eps_u, probs_u, *args)

    PwwPipeline._sag_degraded_eps = sag_spy
    try:
        compare("SAG 0.75", gpu_pipe, cpu_pipe, lambda p: p.generate(**kw, sag_scale=0.75))
    finally:
        PwwPipeline._sag_degraded_eps = real_sag
    flipped = int((masks["cuda"] != masks["cpu"]).sum())
    log(f"[extras reference] SAG: {flipped} of {masks['cpu'].numel()} mask keys differ "
        f"between the card and the CPU at the first visit ({int(masks['cpu'].sum())} set "
        "on the CPU)")
    compare("hires latent", gpu_pipe, cpu_pipe, lambda p: p.generate_hires(
        **{k: v for k, v in kw.items() if k != "return_latents"}, hires_strength=0.7,
        output_type="np"))

    metrics = {}  # ToMe: the first merge's block input on each device
    real_merge = unet_mod.build_token_merge

    def merge_spy(metric, h, w, ratio):
        metrics.setdefault(metric.device.type, (metric.float().cpu(), h, w, ratio))
        return real_merge(metric, h, w, ratio)

    unet_mod.build_token_merge = merge_spy
    try:
        compare("ToMe 0.5", gpu_pipe, cpu_pipe, lambda p: p.generate(
            **dict(kw, color_map_image=cat_dog_map(512)), tome_ratio=0.5))
    finally:
        unet_mod.build_token_merge = real_merge
    merged = {}
    for dev, (m, h, w, ratio) in metrics.items():
        _, unmerge, l_m = real_merge(m, h, w, ratio)
        slots = unmerge(torch.arange(l_m, dtype=torch.float32)[None, :, None]
                        .expand(m.shape[0], -1, -1).contiguous())[..., 0]
        n_unm = l_m - (h // 2) * (w // 2)
        merged[dev] = slots >= n_unm  # dst tokens and the src tokens merged into them
    differ = int((merged["cuda"] != merged["cpu"]).sum())
    log(f"[extras reference] ToMe: at the first site (L {h * w} → {l_m}), {differ} of "
        f"{merged['cpu'].numel()} tokens merged on one device and not on the other")
    del gpu_pipe, cpu_pipe

    lcfg, params, cpu = reduced_sd15(seed=2, time_cond_proj_dim=LCM_COND_DIM)
    gpu_pipe = PwwPipeline(lcfg, params=params, scheduler="lcm", device="cuda",
                           dtype=torch.bfloat16)
    cpu_pipe = PwwPipeline(lcfg, params=cpu, scheduler="lcm", device="cpu", dtype=torch.float32)
    del params, cpu
    compare("LCM 4-step", gpu_pipe, cpu_pipe, lambda p: p.generate(
        **dict(kw, num_inference_steps=4), guidance_scale=8.0))
    del gpu_pipe, cpu_pipe
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"[extras reference] card runs disagree with the CPU: {failed}")
    return results


def phase_extras(pipe, kw, steps):
    """Each extra at SD-1.5 width, 512², on the main pipeline (the LCM run
    on a copy of its UNet with a cond_proj of LCM-Dreamshaper-v7's width),
    the main path's map, prompt and seed: finite latents, the K1/K2/K3
    launches of the table above, an image unlike the plain one; s/image,
    ms/step and peak GiB; then 5-step profiles of DeepCache and ToMe.
    Returns ({run: launches}, {run: profile})."""
    import dataclasses

    import numpy as np
    import torch

    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.schedulers.schedules import t_start_from_strength

    gkw = dict(prompt=kw["input_prompt"], color_map_image=kw["color_map_image"],
               color_context=kw["color_context"], guidance_scale=7.5, seed=0,
               output_type="np")
    counters = launch_counters()
    finite, visits, finals = [], [], []
    decode, denoise = pipe.decode_uint8_device, pipe.denoise

    def checked_decode(lat, *args):
        finite.append(bool(torch.isfinite(lat).all()))
        finals.append(lat.float().clone())
        return decode(lat, *args)

    def counted_denoise(*args, **kwargs):
        before = [c.launches for c in counters[:3]]
        out = denoise(*args, **kwargs)
        visits.append(tuple(c.launches - b for c, b in zip(counters[:3], before)))
        return out

    # the LCM UNet: the main UNet's weights (shared, not copied) and a
    # cond_proj drawn from a seed
    g = torch.Generator(device=pipe.device).manual_seed(3)
    cond = (torch.randn((pipe.config.unet.block_out_channels[0], LCM_COND_DIM), generator=g,
                        device=pipe.device) * 0.02).to(pipe.dtype)
    lcm_cfg = dataclasses.replace(pipe.config, unet=dataclasses.replace(
        pipe.config.unet, time_cond_proj_dim=LCM_COND_DIM))
    lcm = PwwPipeline(lcm_cfg, params={
        "unet": {**pipe.unet.state_dict(), "time_embedding.cond_proj.weight": cond},
        "clip": pipe.clip.state_dict(), "vae": pipe.vae.state_dict()},
        tokenizer=pipe.tokenizer, scheduler="lcm", device=pipe.device, dtype=pipe.dtype,
        profile=True)
    hires_run = steps - t_start_from_strength(steps, 0.7)
    edit_prompt = gkw["prompt"].replace("a cat", "a [cat:fox:0.5]", 1)

    def norms(visits, shallow=0):
        """K4 and K5 of a run's full and shallow UNet visits and its decode."""
        return (SD15_NORMS[0] * visits + SHALLOW_NORMS[0] * shallow + SD15_NORMS[3],
                SD15_NORMS[1] * visits + SHALLOW_NORMS[1] * shallow)

    full = -(-steps // 5)  # DeepCache's full visits at cache_interval 5
    runs = {  # name → (pipeline, call, K1-K5 launches wanted, its last pass's visits)
        "plain": (pipe, lambda n: pipe.generate(**gkw, num_inference_steps=n),
                  tuple(v * steps for v in VISIT) + norms(steps), steps),
        "deepcache": (pipe, lambda n: pipe.generate(**gkw, num_inference_steps=n,
                                                    cache_interval=5),
                      deepcache_launches(steps, 5) + norms(full, steps - full), steps),
        "tome": (pipe, lambda n: pipe.generate(**gkw, num_inference_steps=n, tome_ratio=0.5),
                 tuple(v * steps for v in VISIT) + norms(steps), steps),
        "freeu": (pipe, lambda n: pipe.generate(**gkw, num_inference_steps=n, freeu=True),
                  tuple(v * steps for v in VISIT) + norms(steps), steps),
        "sag": (pipe, lambda n: pipe.generate(**gkw, num_inference_steps=n, sag_scale=0.75),
                tuple(v * steps for v in SAG_VISIT) + norms(2 * steps), steps),
        "lcm": (lcm, lambda n: lcm.generate(**dict(gkw, guidance_scale=8.0),
                                            num_inference_steps=min(n, 4)),
                tuple(v * 4 for v in VISIT) + norms(4), 4),
        "prompt_editing": (pipe, lambda n: pipe.generate(**dict(gkw, prompt=edit_prompt),
                                                         num_inference_steps=n,
                                                         prompt_editing=True),
                           tuple(v * steps for v in VISIT) + norms(steps), steps),
        "hires": (pipe, lambda n: pipe.generate_hires(
            **{k: v for k, v in gkw.items() if k != "output_type"}, num_inference_steps=n,
            hires_strength=0.7, output_type="np"),
            tuple(a * steps + b * hires_run for a, b in zip(VISIT, HIRES_VISIT))
            + norms(steps + hires_run), hires_run),
    }
    launches, images, problems, shapes, encodes = {}, {}, [], {}, {}

    def against_plain(name):
        """Relative L2 of a run's final latents against the plain run's, and
        whether its uint8 image differs (None where the shapes differ)."""
        if name == "plain" or images[name][1].shape != images["plain"][1].shape:
            return None
        lat, ref = images[name][1], images["plain"][1]
        return (float((lat - ref).norm() / ref.norm()),
                not np.array_equal(images[name][0], images["plain"][0]))
    for p in (pipe, lcm):
        p.decode_uint8_device, p.denoise = checked_decode, counted_denoise
    encode = PwwPipeline.encode_inputs
    try:
        for name, (p, call, want, last_visits) in runs.items():
            call(2)  # warm-up: cuDNN plans and the allocator at this run's shapes
            for c in counters:
                c.launches = 0
            finite.clear()
            visits.clear()
            finals.clear()
            seen_prompts = []

            def counted_encode(self, prompt, *args, **kwargs):
                seen_prompts.append(prompt)
                return encode(self, prompt, *args, **kwargs)

            PwwPipeline.encode_inputs = counted_encode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # weights and the encode cache
            with KernelShapes() as ks:
                t0 = time.perf_counter()
                img = call(steps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            PwwPipeline.encode_inputs = encode
            got = {c.__name__: c.launches for c in counters}
            launches[name] = got
            images[name] = img, finals[-1]
            shapes[name] = {n: ks.of(n) for n in KernelShapes.NAMES}
            encodes[name] = sorted(set(seen_prompts))
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            denoise_s = p.timings["denoise"]
            log(f"[extras] {name}: {wall:.3f} s/image, denoise {denoise_s:.3f} s over the "
                f"last pass's {last_visits} visits ({denoise_s / last_visits * 1e3:.1f} "
                f"ms/visit), peak {peak:.2f} GiB above the {held / 2**30:.2f} GiB held before "
                f"it, image {img.shape} mean {img.mean():.2f} std "
                f"{img.std():.2f}; final latents against plain's: {against_plain(name)}; "
                f"launches {got}, K1/K2/K3 per denoise call {visits}; calls by sequence "
                f"length {shapes[name]}; prompts encoded {len(encodes[name])}")
            k = tuple(got[c.__name__] for c in counters)
            if k != want:
                problems.append(f"{name}: launches {k} != {want}")
            if not finite or not all(finite):
                problems.append(f"{name}: latents finite {finite}")
            if name != "plain" and torch.equal(finals[-1], images["plain"][1]):
                problems.append(f"{name}: its final latents equal the plain ones")
    finally:
        PwwPipeline.encode_inputs = encode
        for p in (pipe, lcm):
            del p.decode_uint8_device, p.denoise
    l4096 = 64 * 64
    tome_k3 = shapes["tome"]["flash_self_attention"]
    if tome_k3 != {1024: 5 * steps, l4096 // 2: 5 * steps}:
        problems.append(f"tome: K3 by length {tome_k3}, want 5·{steps} at L 2048 and L 1024")
    hires = shapes["hires"]
    if (hires["fused_pww_reduce"].get(128 * 128) != 5 * hires_run
            or hires["flash_self_attention"].get(128 * 128) != 5 * hires_run
            or images["hires"][0].shape != (1, 1024, 1024, 3)):
        problems.append(f"hires: second pass {hires}, image {images['hires'][0].shape}")
    if len(encodes["prompt_editing"]) != 2:
        problems.append(f"prompt editing: encodes {encodes['prompt_editing']}")
    if problems:
        raise SystemExit(f"[extras] {problems}")
    profiled = {}
    for name in ("deepcache", "tome"):
        profiled[name] = phase_profile(runs[name][1], f"extras {name}")
    del lcm
    torch.cuda.empty_cache()
    return launches, profiled


def inpaint_config():
    """SD-1.5-inpainting at full width, the norm kernels on."""
    import dataclasses

    from pww_tpu_torch.config import SDModelConfig, UNetConfig, VAEConfig

    return SDModelConfig(
        unet=dataclasses.replace(UNetConfig.sd15_inpaint(), fused_group_norm=True,
                                 fused_layer_norm=True),
        vae=dataclasses.replace(VAEConfig.sd15(), fused_group_norm=True))


def inpaint_pipeline(mesh=None):
    """SD-1.5-inpainting at full width, the norm kernels on, synthetic weights
    (on ``mesh``)."""
    import numpy as np
    import torch

    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = inpaint_config()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    pipe = PwwPipeline(cfg, params=params, tokenizer=synthetic_tokenizer(49408),
                       device="cuda", dtype=torch.bfloat16, profile=True, mesh=mesh)
    del params
    torch.cuda.synchronize()
    log(f"[inpaint] SD-1.5-inpainting (conv_in {pipe.unet.conv_in.in_channels} channels), "
        f"fused_group_norm and fused_layer_norm on, set up in {time.perf_counter() - t0:.1f} s")
    cm = np.zeros((512, 512, 3), np.uint8)
    cm[:, :256] = (255, 0, 0)
    cm[:, 256:] = (0, 0, 255)
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=cm, init_image=synthetic_init_image(), mask_image=box_mask(),
              input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, strength=1.0, preloaded_utils=pipe,
              device="cuda", output_type="np")
    return pipe, kw


def record_norm_sites(kw, k4_sites=None, k5_sites=None, tag="norms"):
    """Run one inpaint step, record every K4 and K5 call's signature, and
    check them against ``k4_sites`` and ``k5_sites`` (default K4_SITES and
    K5_SITES)."""
    k4_sites = K4_SITES if k4_sites is None else k4_sites
    k5_sites = K5_SITES if k5_sites is None else k5_sites
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln
    from pww_tpu_torch.pipeline.facade import paint_with_words_inpaint

    gn_sites, ln_sites = {}, {}
    k4, k5 = gn.group_norm, ln.layer_norm

    def gn_rec(x, weight, bias, *, groups, eps, silu=False, add=None, out_dtype=None):
        key = (tuple(x.shape), groups, eps, silu, add is not None)
        gn_sites[key] = gn_sites.get(key, 0) + 1
        return k4(x, weight, bias, groups=groups, eps=eps, silu=silu, add=add,
                  out_dtype=out_dtype)

    def ln_rec(x, weight, bias, *, eps, out_dtype=None):
        key = (tuple(x.shape), eps)
        ln_sites[key] = ln_sites.get(key, 0) + 1
        return k5(x, weight, bias, eps=eps, out_dtype=out_dtype)

    # the wrappers count into whatever their module's name points at
    gn_rec.launches = ln_rec.launches = 0
    gn.group_norm, ln.layer_norm = gn_rec, ln_rec
    try:
        paint_with_words_inpaint(num_inference_steps=1, **kw)  # also the warm-up
    finally:
        gn.group_norm, ln.layer_norm = k4, k5
    log(f"[{tag}] one inpaint step: {sum(gn_sites.values())} K4 calls at {len(gn_sites)} "
        f"signatures, {sum(ln_sites.values())} K5 calls at {len(ln_sites)}")
    want_gn = {site: k4_calls(site, 1, table=k4_sites) for site in k4_sites}
    if gn_sites != want_gn or ln_sites != k5_sites:
        raise SystemExit(f"[{tag}] recorded sites differ from the table: K4 {gn_sites} != "
                         f"{want_gn} or K5 {ln_sites} != {k5_sites}")


def phase_norm_kernels():
    """K4 and K5 against their plain versions at every site signature of the
    inpaint path (K4_SITES, K5_SITES) and K4's two cases off it."""
    import torch
    import torch.nn.functional as F

    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape, mean=0.0, std=1.0):
        x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
        return (x * std + mean).to(bf16)

    cases = Cases()
    # Both sides take f32 statistics of the same bf16 values in another order
    # and round y to bf16, so an element may round the other way: one bf16
    # ulp, 2^-8 to 2^-7 of it. The limits are 2-4 ulps of the largest output
    # and 1e-3 in relative L2, which one-ulp flips reach only on a few % of
    # the elements; a wrong group, channel or pre-add moves it by about 1e-1.
    gn_cases = [(k, 0.0) for k in K4_SITES]
    big_unet = max((k for k in K4_SITES if k[0][0] == 2), key=lambda k: (math.prod(k[0]), k[4]))
    gn_cases.append((big_unet, 8.0))  # |mean| ≫ std: the fast variance cancels
    # SDXL-inpainting's signatures at 1024² (its VAE's largest spans streamed)
    gn_cases += [(k, 0.0) for k in XL_K4_SITES if k not in K4_SITES]
    gn_cases += [(k, 0.0) for k in K4_OFF_PATH]
    plan_of = getattr(gn, "group_norm_plan", None)  # absent in a parent tree
    for site, mean in gn_cases:
        shape, groups, eps, silu, has_add = site
        n, c = shape[:2]
        x = randn(*shape, mean=mean)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        add = randn(n, c) if has_add else None
        kw = dict(groups=groups, eps=eps, silu=silu, add=add)
        got = gn.group_norm(x, w, b, **kw)
        want = gn.group_norm_plain(x, w, b, **kw)
        lib = None
        if not silu and add is None:
            lib = time_ms(lambda: F.group_norm(x, groups, w, b, eps))
        nbytes = 2 * x.numel() * 2 + (n * c * 2 if has_add else 0) + 2 * c * 2
        bnd = bound(nbytes, (12 if silu else 8) * x.numel(), F32_FLOPS_PER_S)
        label = k4_label(site, mean)
        cases.record("group_norm", label, got, want, 2**-6 * want.float().abs().max().item(),
                     1e-3, time_ms(lambda: gn.group_norm(x, w, b, **kw)),
                     time_ms(lambda: gn.group_norm_plain(x, w, b, **kw), reps=5), bnd, lib,
                     calls=k4_calls(site, STEPS_PER_RUN) if site in K4_SITES and not mean
                     else None)
        if plan_of is not None:
            cpg = c // groups
            plan = plan_of(cpg * math.prod(shape[2:]), cpg, n * groups,
                           gn._max_cluster(torch.cuda.current_device()))
            log(f"[norms]   plan: cluster {plan.cluster}, piece {plan.piece}, resident "
                f"{plan.resident}{' (streamed)' if plan.streamed else ''}, "
                f"{plan.smem_bytes} B shared memory and {plan.threads} threads per CTA")
            if plan.streamed and site in K4_SITES:
                # the alternative: as much of each piece resident as fits
                # (one CTA per SM), the rest read twice
                res = (gn.SMEM_PER_CTA - gn._smem_bytes(0, cpg)) // 16 * 8
                held = plan._replace(resident=res, smem_bytes=gn._smem_bytes(res, cpg),
                                     threads=512)
                run = lambda: gn._launch(x, w, b, add, groups=groups, eps=eps, silu=silu,
                                         out_dtype=bf16, plan=held)
                cases.record("group_norm", label + " most-resident", run(), want,
                             2**-6 * want.float().abs().max().item(), 1e-3, time_ms(run),
                             cases.by_kernel["group_norm"][-1]["plain_ms"], bnd, lib)
                # what one read and one write of x take on this card
                copy = torch.empty_like(x)
                log(f"[norms]   a copy of x (one read, one write): "
                    f"{time_ms(lambda: copy.copy_(x)):.4f} ms")
        del x, got, want
        torch.cuda.empty_cache()
    # K4's split form (a spatially sharded site at dp 2): each half of the
    # rows' statistics kernel, the halves combined (Chan's rule, in order),
    # each half's apply kernel; held against the plain version on the whole
    # tensor and against the one-launch K4 on it, at K4's limits. Timed: one
    # rank's work, the statistics and the apply on its half.
    from pww_tpu_torch.parallel.spatial import chan_moments

    for site in SPLIT_K4_SITES:
        shape, groups, eps, silu, has_add = site
        n, c = shape[:2]
        x = randn(*shape)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        add = randn(n, c) if has_add else None
        halves = [h.contiguous() for h in x.chunk(2, dim=2)]

        def split(stats_fn, apply_fn, parts=halves):
            st = torch.stack([stats_fn(h, groups=groups, add=add).movedim(-1, 0)
                              for h in parts])
            mean, var = chan_moments(st, parts[0][0].numel() // groups)
            ms = torch.stack([mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)], dim=-1)
            return torch.cat([apply_fn(h, w, b, ms, groups=groups, silu=silu, add=add)
                              for h in parts], dim=2)

        got = split(gn.group_norm_stats, gn.group_norm_apply)
        want = gn.group_norm_plain(x, w, b, groups=groups, eps=eps, silu=silu, add=add)
        one = gn.group_norm(x, w, b, groups=groups, eps=eps, silu=silu, add=add)
        half = halves[0]

        def rank_split(stats_fn, apply_fn):
            st = stats_fn(half, groups=groups, add=add)
            m = st[..., 0]
            ms = torch.stack([m, torch.rsqrt(st[..., 1] / (half[0].numel() // groups) + eps)],
                             dim=-1)
            return apply_fn(half, w, b, ms, groups=groups, silu=silu, add=add)

        nbytes = 2 * half.numel() * 2 + (n * c * 2 if has_add else 0) + 2 * c * 2
        label = f"split {k4_label(site)} halves"
        tol = 2**-6 * want.float().abs().max().item()
        cases.record("group_norm_split", label, got, want, tol, 1e-3,
                     time_ms(lambda: rank_split(gn.group_norm_stats, gn.group_norm_apply)),
                     time_ms(lambda: rank_split(gn.group_norm_stats_plain,
                                                gn.group_norm_apply_plain), reps=5),
                     bound(nbytes, (12 if silu else 8) * half.numel(), F32_FLOPS_PER_S), None,
                     calls=SPLIT_K4_SITES[site])
        diff = (got.float() - one.float())
        err, rel = diff.abs().max().item(), (diff.norm() / one.float().norm()).item()
        log(f"[norms]   {label} against the one-launch K4 on the whole tensor: max_abs_err "
            f"{err:.3e} (tol {tol:.3e}), rel_l2 {rel:.3e} (tol 0.001)")
        if not (err <= tol and rel <= 1e-3):
            cases.failed.append(f"group_norm_split {label} against the one-launch K4")
        del x, halves, half, got, want, one
        torch.cuda.empty_cache()
    k5_cases = [(k, 0.0) for k in K5_SITES] + [(max(K5_SITES), 8.0)]
    k5_cases += [(k, 0.0) for k in XL_K5_SITES if k not in K5_SITES]
    for site, mean in k5_cases:
        shape, eps = site
        c = shape[-1]
        x = randn(*shape, mean=mean)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        got = ln.layer_norm(x, w, b, eps=eps)
        want = ln.layer_norm_plain(x, w, b, eps=eps)
        cases.record("layer_norm", k5_label(site, mean),
                     got, want, 2**-6 * want.float().abs().max().item(), 1e-3,
                     time_ms(lambda: ln.layer_norm(x, w, b, eps=eps)),
                     time_ms(lambda: ln.layer_norm_plain(x, w, b, eps=eps)),
                     bound(2 * x.numel() * 2 + 2 * c * 2, 8 * x.numel(), F32_FLOPS_PER_S),
                     time_ms(lambda: F.layer_norm(x, (c,), w, b, eps)),
                     calls=K5_SITES[site] * STEPS_PER_RUN if site in K5_SITES and not mean
                     else None)
    torch.cuda.empty_cache()
    serve_norm_cases(cases, randn)
    for name, cs in cases.by_kernel.items():
        log(f"[norms] {name}: loss_ms_per_run {loss_ms_per_run(cs):.3f}")
    cases.check()
    return cases.by_kernel


def serve_norm_cases(cases, randn):
    """K4 and K5 at every signature of the served path (SERVE_K4_SITES,
    SERVE_K5_SITES) against their plain versions at phase 3's limits, each
    timed beside the f32 composition that the sites ran before the rule
    sent them to the kernels (the pre-add in bf16, then ``group_norm_f32``;
    ``layer_norm_f32``); the composition's ms goes into the case as
    ``composition_ms``. Logs the device ms a 30-step group of 8 spends in
    each form."""
    import torch

    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    bf16 = torch.bfloat16
    spent = {"kernel": 0.0, "composition": 0.0, "bound": 0.0}

    def timed(kernel, label, site_calls, got, want, run, plain, compose, bnd):
        ms, comp = time_ms(run), time_ms(compose)
        cases.record(kernel, label, got, want, 2**-6 * want.float().abs().max().item(), 1e-3,
                     ms, time_ms(plain, reps=5), bnd, None)
        cases.by_kernel[kernel][-1]["composition_ms"] = comp
        log(f"[norms]   {label}: the f32 composition {comp:.4f} ms, {site_calls} calls a "
            f"group of 8")
        for key, v in (("kernel", ms), ("composition", comp), ("bound", bnd[0])):
            spent[key] += site_calls * v

    for site, (u, _, d) in SERVE_K4_SITES.items():
        shape, groups, eps, silu, has_add = site
        n, c = shape[:2]
        x = randn(*shape)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        add = randn(n, c) if has_add else None
        kw = dict(groups=groups, eps=eps, silu=silu, add=add)
        mod = torch.nn.GroupNorm(groups, c, eps=eps, device="cuda", dtype=bf16)
        mod.requires_grad_(False)
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        nbytes = 2 * x.numel() * 2 + (n * c * 2 if has_add else 0) + 2 * c * 2
        timed("group_norm", k4_label(site), u * STEPS_PER_RUN + d,
              gn.group_norm(x, w, b, **kw), gn.group_norm_plain(x, w, b, **kw),
              lambda: gn.group_norm(x, w, b, **kw), lambda: gn.group_norm_plain(x, w, b, **kw),
              lambda: gn.group_norm_f32(mod, gn._with_add(x, add), silu=silu),
              bound(nbytes, (12 if silu else 8) * x.numel(), F32_FLOPS_PER_S))
        del x, mod
        torch.cuda.empty_cache()
    for site, calls in SERVE_K5_SITES.items():
        shape, eps = site
        c = shape[-1]
        x = randn(*shape)
        w, b = randn(c, mean=1.0, std=0.1), randn(c, std=0.1)
        mod = torch.nn.LayerNorm(c, eps=eps, device="cuda", dtype=bf16)
        mod.requires_grad_(False)
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        timed("layer_norm", k5_label(site), calls * STEPS_PER_RUN,
              ln.layer_norm(x, w, b, eps=eps), ln.layer_norm_plain(x, w, b, eps=eps),
              lambda: ln.layer_norm(x, w, b, eps=eps),
              lambda: ln.layer_norm_plain(x, w, b, eps=eps), lambda: ln.layer_norm_f32(mod, x),
              bound(2 * x.numel() * 2 + 2 * c * 2, 8 * x.numel(), F32_FLOPS_PER_S))
    torch.cuda.empty_cache()
    log(f"[norms] served path, a 30-step group of 8 (every K4 and K5 site, its decode "
        f"included): kernels {spent['kernel']:.1f} ms, the f32 composition "
        f"{spent['composition']:.1f} ms, bound {spent['bound']:.1f} ms of device time")


def phase_inpaint_reference():
    """Reduced-depth SD-1.5-width 9-channel inpaint with the norm kernels on:
    card bf16 vs CPU f32 (where K4 and K5 take their plain versions)."""
    import dataclasses

    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import synthetic_params

    clip = CLIPTextConfig.tiny()
    cfg = SDModelConfig(
        clip=clip,
        unet=UNetConfig(in_channels=9, block_out_channels=(320, 640), layers_per_block=1,
                        down_block_has_attn=(True, False),
                        cross_attention_dim=clip.hidden_size, fused_group_norm=True,
                        fused_layer_norm=True),
        vae=dataclasses.replace(VAEConfig.tiny(), fused_group_norm=True),
    )
    params = synthetic_params(cfg, seed=2, device="cuda", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    cm[:, 128:] = (0, 0, 255)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              init_image=synthetic_init_image(256), mask_image=box_mask(256), strength=1.0,
              num_inference_steps=3, seed=0, vae_sample_mode="mean", return_latents=True)
    gn.group_norm.launches = ln.layer_norm.launches = 0
    gpu = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16).generate(**kw)
    launched = (gn.group_norm.launches, ln.layer_norm.launches)
    ref = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32).generate(**kw)
    rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
    ok = np.isfinite(gpu).all() and rel < 5e-2 and min(launched) > 0
    log(f"[inpaint reference] 256 px, 3 steps, 9-channel (320, 640)-channel UNet, norm "
        f"kernels on (K4 {launched[0]}, K5 {launched[1]} launches): card bf16 vs CPU f32 "
        f"relative L2 error {rel:.3e} (tol 5e-2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[inpaint reference] card run disagrees with the CPU reference")


def phase_inpaint(pipe, kw, steps):
    """The inpaint path at full width, launch counts checked."""
    import numpy as np
    import torch

    from pww_tpu_torch.pipeline.facade import paint_with_words_inpaint

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = paint_with_words_inpaint(num_inference_steps=steps, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    log(f"[inpaint] paint_with_words_inpaint 512², {steps} LMS steps, strength 1.0, CFG 7.5: "
        f"encode {tm['encode']:.3f} s (two VAE encodes included), denoise "
        f"{tm['denoise']:.3f} s ({tm['denoise'] / steps * 1e3:.1f} ms/step), decode "
        f"{tm['decode']:.3f} s, {total:.3f} s/image, peak {peak:.2f} GiB")
    log(f"[inpaint] launches: {launches}")
    lat = pipe.generate(prompt=kw["input_prompt"], color_map_image=kw["color_map_image"],
                        color_context=kw["color_context"], init_image=kw["init_image"],
                        mask_image=kw["mask_image"], strength=1.0,
                        num_inference_steps=steps, seed=0, return_latents=True)
    want = {"fused_pww_reduce": 15 * steps, "fused_pww_cross_attention": 15 * steps,
            "flash_self_attention": 10 * steps,
            "group_norm": 61 * steps + 2 * 22 + 30, "layer_norm": 48 * steps}
    problems = []
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
        problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
    if not np.isfinite(lat).all() or lat.shape != (1, 64, 64, 4):
        problems.append(f"latents {lat.shape}, finite={np.isfinite(lat).all()}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    log(f"[inpaint] image {img.shape} {img.dtype} mean {img.mean():.2f} std {img.std():.2f}; "
        f"latents finite, |max| {np.abs(lat).max():.3f}")
    if problems:
        raise SystemExit(f"[inpaint] {problems}")
    return launches


# -- single files, textual inversion, caller latents, save_pretrained, the apps --

_UNET_RES_LDM = {"norm1": "in_layers.0", "conv1": "in_layers.2",
                 "time_emb_proj": "emb_layers.1", "norm2": "out_layers.0",
                 "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_VAE_RES_LDM = {"conv_shortcut": "nin_shortcut"}
_VAE_ATTN_LDM = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
                 "to_out.0": "proj_out"}


def ldm_state_dict(config, params):
    """The port's {"unet", "vae", "clip"} state dicts as one A1111/LDM
    single file's state dict: the inverse of
    ``pww_tpu_torch/weights/ldm_convert.py``'s renaming for ``config``'s
    layers a UNet block and VAE blocks, the VAE attention's Linear weights
    as 1×1 convs, and the int64 ``position_ids`` buffer real SD-1.x files
    carry."""
    import re

    import torch

    def rename(rest, table):
        for src, dst in table.items():
            if rest.startswith(src + "."):
                return dst + rest[len(src):]
        return rest

    u = config.unet
    per = u.layers_per_block + 1
    nb = len(config.vae.block_out_channels)
    out = {}
    for k, v in params["unet"].items():
        fixed = {"time_embedding.linear_1.": "time_embed.0.",
                 "time_embedding.linear_2.": "time_embed.2.", "conv_in.": "input_blocks.0.0.",
                 "conv_norm_out.": "out.0.", "conv_out.": "out.2."}
        src = next((s for s in fixed if k.startswith(s)), None)
        m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)"
                     r"\.(\d+)\.(.+)", k)
        mid = re.match(r"mid_block\.(resnets|attentions)\.(\d+)\.(.+)", k)
        if src is not None:
            key = fixed[src] + k[len(src):]
        elif m and m[1] == "down":
            b, kind, j, rest = int(m[2]), m[3], int(m[4]), m[5]
            if kind == "downsamplers":  # "conv.weight" → "op.weight"
                key = f"input_blocks.{1 + b * per + u.layers_per_block}.0.op.{rest[5:]}"
            elif kind == "resnets":
                key = f"input_blocks.{1 + b * per + j}.0.{rename(rest, _UNET_RES_LDM)}"
            else:
                key = f"input_blocks.{1 + b * per + j}.1.{rest}"
        elif m:
            b, kind, j, rest = int(m[2]), m[3], int(m[4]), m[5]
            if kind == "upsamplers":
                sub = 2 if u.up_block_has_attn[b] else 1
                key = f"output_blocks.{b * per + u.layers_per_block}.{sub}.{rest}"
            elif kind == "resnets":
                key = f"output_blocks.{b * per + j}.0.{rename(rest, _UNET_RES_LDM)}"
            else:
                key = f"output_blocks.{b * per + j}.1.{rest}"
        elif mid:
            key = (f"middle_block.{2 * int(mid[2])}.{rename(mid[3], _UNET_RES_LDM)}"
                   if mid[1] == "resnets" else f"middle_block.1.{mid[3]}")
        else:
            raise KeyError(f"no LDM name for the UNet's {k}")
        out["model.diffusion_model." + key] = v
    for k, v in params["vae"].items():
        key = k
        if not k.startswith(("quant_conv.", "post_quant_conv.")):
            side, rest = k.split(".", 1)
            m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets\.(\d+)|downsamplers\.0|upsamplers\.0)"
                         r"\.(.+)", rest)
            mid = re.match(r"mid_block\.(resnets|attentions)\.(\d+)\.(.+)", rest)
            if rest.startswith("conv_norm_out."):
                rest = "norm_out." + rest[len("conv_norm_out."):]
            elif m:
                i = int(m[2]) if m[1] == "down" else nb - 1 - int(m[2])
                if m[4] is not None:
                    rest = f"{m[1]}.{i}.block.{m[4]}.{rename(m[5], _VAE_RES_LDM)}"
                else:  # "conv.weight" under the down/upsampler
                    rest = f"{m[1]}.{i}.{m[1]}sample.{m[5]}"
            elif mid and mid[1] == "resnets":
                rest = f"mid.block_{int(mid[2]) + 1}.{rename(mid[3], _VAE_RES_LDM)}"
            elif mid:
                rest = f"mid.attn_1.{rename(mid[3], _VAE_ATTN_LDM)}"
                if v.dim() == 2:  # the LDM VAE's attention projections are 1×1 convs
                    v = v[:, :, None, None]
            key = f"{side}.{rest}"
        out["first_stage_model." + key] = v
    for k, v in params["clip"].items():
        out["cond_stage_model.transformer." + k] = v
    out["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(
        config.clip.max_position_embeddings, dtype=torch.int64)[None]
    return out


def depth_cut_sd15():
    """SD-1.5 at its published widths, cut in depth: one layer a UNet and VAE
    block, a 2-layer text tower."""
    import dataclasses

    from pww_tpu_torch.config import SDModelConfig

    cfg = SDModelConfig.sd15()
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, num_layers=2),
        unet=dataclasses.replace(cfg.unet, layers_per_block=1),
        vae=dataclasses.replace(cfg.vae, layers_per_block=1))


def ldm_bert_state(cfg, seed=0, device="cuda"):
    """An original-LDM BERT tower's state dict (``cond_stage_model.transformer.``
    stripped, x-transformers' names), drawn on ``device`` in f32: N(0, 0.02)
    weights (BERT's ``initializer_range``, and ``synthetic_params``' scale),
    norms near 1. At N(0, 0.08) the 1280-wide random tower amplifies bf16
    rounding several times over, in the JAX package's bf16 forward as in the
    port's (tests/test_torch_ldm.py::test_ldm_bert_bf16_rounding_matches_jax)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=0.02, base=0.0):
        return base + scale * torch.randn(shape, generator=g, device=device)

    sd = {"token_emb.weight": r(cfg.vocab_size, cfg.d_model),
          "pos_emb.emb.weight": r(cfg.max_position_embeddings, cfg.d_model),
          "norm.weight": r(cfg.d_model, scale=0.008, base=1.0),
          "norm.bias": r(cfg.d_model, scale=0.008),
          "to_logits.weight": r(cfg.vocab_size, cfg.d_model),
          "to_logits.bias": r(cfg.vocab_size, scale=0.008)}
    for i in range(cfg.num_layers):
        a, f = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}"
        sd[f"{a}.0.weight"] = r(cfg.d_model, scale=0.008, base=1.0)
        sd[f"{a}.0.bias"] = r(cfg.d_model, scale=0.008)
        for p in ("to_q", "to_k", "to_v"):
            sd[f"{a}.1.{p}.weight"] = r(cfg.inner_dim, cfg.d_model)
        sd[f"{a}.1.to_out.weight"] = r(cfg.d_model, cfg.inner_dim)
        sd[f"{a}.1.to_out.bias"] = r(cfg.d_model, scale=0.008)
        sd[f"{f}.0.weight"] = r(cfg.d_model, scale=0.008, base=1.0)
        sd[f"{f}.0.bias"] = r(cfg.d_model, scale=0.008)
        sd[f"{f}.1.net.0.0.weight"] = r(cfg.ffn_dim, cfg.d_model)
        sd[f"{f}.1.net.0.0.bias"] = r(cfg.ffn_dim, scale=0.008)
        sd[f"{f}.1.net.2.weight"] = r(cfg.d_model, cfg.ffn_dim)
        sd[f"{f}.1.net.2.bias"] = r(cfg.d_model, scale=0.008)
    return sd


def write_embeddings(d, width, seed=0):
    """A two-vector A1111 ``.pt`` and a one-vector diffusers ``.safetensors``
    embedding, ``width`` wide, in directory ``d``; returns [(path,
    vectors)]."""
    import torch

    from pww_tpu_torch.weights import safetensors_io

    g = torch.Generator().manual_seed(seed)
    two = torch.randn((2, width), generator=g) * 0.3
    one = torch.randn((width,), generator=g) * 0.3
    a1111, diffusers = os.path.join(d, "cat-toy.pt"), os.path.join(d, "dog-toy.safetensors")
    torch.save({"string_to_token": {"*": torch.tensor(265)},
                "string_to_param": {"*": torch.nn.Parameter(two)}, "name": "<cat-toy>",
                "step": 3000, "sd_checkpoint_name": "synthetic"}, a1111)
    safetensors_io.save_file({"<dog-toy>": one}, diffusers)
    return [(a1111, two), (diffusers, one[None])]


TI_PROMPT = "a photo of <cat-toy> <cat-toy>_1 sitting next to <dog-toy>, realistic photo"
TI_CONTEXT = {(255, 0, 0): "<cat-toy> <cat-toy>_1,0.5", (0, 0, 255): "<dog-toy>,0.5"}


def apply_embeddings(pipe, embeddings):
    """Each embedding file into ``pipe``; returns the placeholders' token ids."""
    from pww_tpu_torch.weights.textual_inversion import apply_textual_inversion

    ids = []
    for path, _ in embeddings:
        for name in apply_textual_inversion(pipe, path).split():
            ids.append(pipe.tokenizer.convert_tokens_to_ids(name))
    return ids


def check_embedding_rows(pipe, ids, embeddings, tag):
    """The text tower's rows at ``ids`` must be the files' vectors in the
    pipeline's type, bit for bit."""
    import torch

    table = pipe.clip.text_model.embeddings.token_embedding.weight
    want = torch.cat([v for _, v in embeddings]).to(table.device, table.dtype)
    same = torch.equal(table[torch.tensor(ids, device=table.device)], want)
    log(f"[{tag}] embedding rows at ids {ids} equal the files' vectors in {table.dtype}: "
        f"{same}; table {tuple(table.shape)}, config vocab {pipe.config.clip.vocab_size}")
    return same and pipe.config.clip.vocab_size == table.shape[0]


def phase_single_file(steps, card):
    """SD-1.5 at full width as an A1111/LDM single file, through the
    reference's own surface: load, textual inversion, caller latents,
    ``save_pretrained``, the runner and the apps' callbacks, and LDM-BERT.
    Every file it writes is deleted. Returns (launches of the N-step call
    with latents, its profile)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pww_tpu_torch.apps import gradio_pww, gradio_pww_inpaint, runner, runner_inpaint
    from pww_tpu_torch.conditioning.seeding import make_noise
    from pww_tpu_torch.config import LDMBertConfig, SDModelConfig
    from pww_tpu_torch.models.ldm_bert import LDMBertModel
    from pww_tpu_torch.pipeline.facade import paint_with_words, pww_load_tools
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.schedulers.schedules import make_scheduler
    from pww_tpu_torch.tokenizer.clip_bpe import save_tokenizer_assets, synthetic_tokenizer
    from pww_tpu_torch.weights import safetensors_io
    from pww_tpu_torch.weights.bridge import synthetic_params
    from pww_tpu_torch.weights.ldm_convert import convert_ldm_bert, load_ldm_checkpoint

    problems = []
    root = tempfile.mkdtemp(prefix="pww_single_")
    try:
        # 1. a full-width SD-1.5 single file, fp16, with the tokenizer's files beside it
        cfg = SDModelConfig.sd15()
        path = os.path.join(root, "sd15.safetensors")
        params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.float16)
        n_params = sum(v.numel() for sd in params.values() for v in sd.values())
        t0 = time.perf_counter()
        safetensors_io.save_file(ldm_state_dict(cfg, params), path)
        write_s = time.perf_counter() - t0
        save_tokenizer_assets(synthetic_tokenizer(49408), root)
        log(f"[single] SD-1.5, {n_params:.4e} synthetic parameters: LDM single file of "
            f"{os.path.getsize(path) / 1e9:.3f} GB (fp16 safetensors, I64 position_ids) "
            f"written in {write_s:.1f} s, the tokenizer's files beside it in "
            f"{time.perf_counter() - t0 - write_s:.1f} s")

        # 2. load it through the facade's loader
        t0 = time.perf_counter()
        pipe = pww_load_tools("cuda", "lms", local_model_path=path)
        torch.cuda.synchronize()
        log(f"[single] loaded by pww_load_tools → load_ldm_checkpoint to the card in bf16 "
            f"in {time.perf_counter() - t0:.1f} s; config is SDModelConfig.sd15(): "
            f"{pipe.config == cfg}")
        if pipe.config != cfg:
            problems.append(f"detected config {pipe.config}")
        unequal = [f"{part}.{k}" for part, module in (("unet", pipe.unet), ("clip", pipe.clip),
                                                     ("vae", pipe.vae))
                   for k, t in module.state_dict().items()
                   if not torch.equal(t, params[part][k].to(torch.bfloat16))]
        log(f"[single] loaded tensors equal to the written fp16 values in bf16: "
            f"{sum(len(p) for p in params.values()) - len(unequal)} of "
            f"{sum(len(p) for p in params.values())}")
        if unequal:
            problems.append(f"{len(unequal)} loaded tensors differ: {unequal[:4]}")
        del params
        torch.cuda.empty_cache()

        # 3. two textual-inversion files, placeholders in the prompt and the labels
        embeddings = write_embeddings(root, cfg.clip.hidden_size)
        ids = apply_embeddings(pipe, embeddings)
        if not check_embedding_rows(pipe, ids, embeddings, "single"):
            problems.append("embedding rows")
        cm = cat_dog_map(512)
        enc = pipe.encode_inputs(TI_PROMPT, cm, TI_CONTEXT)
        cols = [p for p, i in enumerate(enc.prompt_ids) if i in ids]
        bound = [float(enc.pww.weights[4096][1][:, p].abs().sum()) > 0 for p in cols]
        log(f"[single] placeholder ids at prompt positions {cols}; the PwW weights bind "
            f"them: {bound}")
        if len(cols) != len(ids) or not all(bound):
            problems.append(f"PwW binding of the placeholders {cols} {bound}")

        # 4. caller latents (NHWC) against seed=, 30 LMS steps
        pipe.profile = True
        kw = dict(local_model_path=path, device="cuda", color_context=TI_CONTEXT,
                  color_map_image=cm, input_prompt=TI_PROMPT, guidance_scale=7.5,
                  output_type="np")
        # the draw seed=0 makes in the default noise mode
        latents = make_noise(0, (1, 4, 64, 64), "jax", "cuda").permute(0, 2, 3, 1)
        paint_with_words(num_inference_steps=2, latents=latents, **kw)  # warm-up
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = paint_with_words(num_inference_steps=steps, latents=latents, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        tm = pipe.timings
        log(f"[single] paint_with_words 512², {steps} LMS steps, CFG 7.5, latents given: "
            f"encode {tm['encode']:.3f} s, denoise {tm['denoise']:.3f} s "
            f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s, "
            f"{total:.3f} s/image, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card}); launches {launches}")
        want = path_launches(steps)
        if launches != want:
            problems.append(f"launches {launches} != {want}")
        seeded = paint_with_words(num_inference_steps=steps, seed=0, **kw)
        rel = rel_l2(img, seeded)
        log(f"[single] latents=make_noise(0) against seed=0: image relative L2 {rel:.3e} "
            f"(tol 1e-3), bit-equal {np.array_equal(img, seeded)}")
        if img.shape != (1, 512, 512, 3) or img.std() == 0 or not rel < 1e-3:
            problems.append(f"image {img.shape} std {img.std():.2f}, latents vs seed {rel:.3e}")
        profiled = phase_profile(
            lambda n: paint_with_words(num_inference_steps=n, latents=latents, **kw), "single")

        # 5. the depth-cut config as a single file, card bf16 against CPU f32
        small = depth_cut_sd15()
        small_path = os.path.join(root, "sd15_depth_cut.safetensors")
        sp = synthetic_params(small, seed=2, device="cuda", dtype=torch.float32)
        # std 0.1 rather than 0.02, as phase_reference, so that the steps move the latents
        safetensors_io.save_file(ldm_state_dict(small, {
            p: {k: (v * 5.0).half() for k, v in sd.items()} for p, sd in sp.items()}),
            small_path)
        del sp
        small_embeddings = write_embeddings(root, small.clip.hidden_size, seed=1)
        lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 32, 32, 4)).astype(np.float32))
        runs = {}
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            _, sd, tok = load_ldm_checkpoint(small_path, config=small)
            sp_pipe = PwwPipeline(small, params=sd, tokenizer=tok, device=device, dtype=dtype)
            apply_embeddings(sp_pipe, small_embeddings)
            runs[device] = sp_pipe.generate(
                prompt=TI_PROMPT, color_map_image=cat_dog_map(256), color_context=TI_CONTEXT,
                num_inference_steps=4, latents=lat, return_latents=True)
            if device == "cuda":
                card_pipe = sp_pipe
        rel = rel_l2(runs["cuda"], runs["cpu"])
        ok = bool(np.isfinite(runs["cuda"]).all()) and rel < 5e-2
        log(f"[single reference] depth-cut SD-1.5 single file + an embedding, 256 px, 4 steps "
            f"with latents: card bf16 vs CPU f32 relative L2 {rel:.3e} (tol 5e-2) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"depth-cut reference {rel:.3e}")

        # 6. save_pretrained → from_pretrained at full width
        saved = os.path.join(root, "saved")
        pipe.scheduler = make_scheduler("ddim")  # recorded, and must come back
        t0 = time.perf_counter()
        pipe.save_pretrained(saved)
        save_s = time.perf_counter() - t0
        pipe.scheduler = make_scheduler("lms")
        t0 = time.perf_counter()
        back = PwwPipeline.from_pretrained(saved, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        unequal = [k for m, n in ((pipe.unet, back.unet), (pipe.clip, back.clip),
                                  (pipe.vae, back.vae))
                   for k, t in m.state_dict().items() if not torch.equal(t, n.state_dict()[k])]
        log(f"[single] save_pretrained wrote {dir_gb(saved):.3f} GB in {save_s:.1f} s, "
            f"from_pretrained read it in {load_s:.1f} s: weights bit-equal "
            f"{not unequal}, scheduler {back.scheduler.kind} (saved ddim)")
        if unequal or back.scheduler.kind != "ddim":
            problems.append(f"round trip: {unequal[:4]}, scheduler {back.scheduler.kind}")
        back.scheduler = make_scheduler("lms")
        apply_embeddings(back, embeddings)  # the tokenizer's files hold no added tokens
        again = back.generate(prompt=TI_PROMPT, color_map_image=cm, color_context=TI_CONTEXT,
                              num_inference_steps=steps, latents=latents, output_type="np")
        rel = rel_l2(again, img)
        log(f"[single] the reloaded pipeline's {steps}-step image against step 4's: relative "
            f"L2 {rel:.3e} (tol 1e-3)")
        if not rel < 1e-3:
            problems.append(f"round-trip image {rel:.3e}")
        del back
        shutil.rmtree(saved)
        torch.cuda.empty_cache()

        # 7. the runner on the single file, then the apps on the depth-cut config
        out = os.path.join(root, "runner")
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        runner.main(["--model", path, "--only", "cat_dog", "--out", out, "--device", "cuda"])
        launches_r = {c.__name__: c.launches for c in counters}
        from PIL import Image

        sizes = {f: Image.open(os.path.join(out, f)).size for f in sorted(os.listdir(out))}
        log(f"[single] runner.main --model <file> --only cat_dog ({steps} steps): "
            f"{time.perf_counter() - t0:.1f} s with the load, launches {launches_r}, "
            f"files {sizes}")
        if launches_r != want or sizes.get("output_cat_dog.png") != (512, 512):
            problems.append(f"runner: launches {launches_r}, files {sizes}")
        small_dir = os.path.join(root, "depth_cut")
        card_pipe.save_pretrained(small_dir)
        del card_pipe
        gradio_pww._PIPE = gradio_pww_inpaint._PIPE = None
        hint = cat_dog_map(256)
        context = "{(255, 0, 0): 'cat,1.0', (0, 0, 255): 'dog,1.0'}"
        images = gradio_pww.run_pww(hint, context, "a cat sitting next to a dog", "", None,
                                    256, 256, 1, 4, 7.5, 0, 0.5, model_path=small_dir,
                                    device="cuda")
        inpainted = gradio_pww_inpaint.run_pww_inpaint(
            hint, context, "a cat sitting next to a dog", "",
            {"image": synthetic_init_image(256), "mask": (box_mask(256)[..., None] * 255).repeat(
                3, -1).astype(np.uint8)}, 256, 256, 1, 4, 7.5, 0, 1.0,
            model_path=small_dir, device="cuda")
        out2 = os.path.join(root, "runner_inpaint")
        runner_inpaint.main(["--model", small_dir, "--steps", "4", "--out", out2,
                             "--device", "cuda"])
        sizes2 = {f: Image.open(os.path.join(out2, f)).size for f in sorted(os.listdir(out2))}
        got = [im.size for im in images + inpainted]
        log(f"[single] run_pww and run_pww_inpaint on the depth-cut model (256², 4 steps): "
            f"{got}, std {[float(np.asarray(im).std()) for im in images + inpainted]}; "
            f"runner_inpaint (512², 4 steps): {sizes2}")
        if got != [(256, 256)] * 2 or sorted(sizes2.values()) != [(512, 512)] * 2:
            problems.append(f"apps: {got}, {sizes2}")
        gradio_pww._PIPE = gradio_pww_inpaint._PIPE = None

        # 8. LDM-BERT at its published size, card bf16 against CPU f32
        bcfg = LDMBertConfig()
        bert_sd = ldm_bert_state(bcfg)
        conf, state = convert_ldm_bert(bert_sd)
        del bert_sd
        ids_b = torch.from_numpy(np.random.default_rng(0).integers(
            0, bcfg.vocab_size, (1, bcfg.max_position_embeddings)))
        outs = {}
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            with torch.device("meta"):
                bert = LDMBertModel(conf)
            bert.load_state_dict({k: v.to(device, dtype) for k, v in state.items()},
                                 assign=True)
            with torch.inference_mode():
                outs[device] = bert(ids_b.to(device)).float().cpu().numpy()
            del bert
        rel = rel_l2(outs["cuda"], outs["cpu"])
        ok = conf == bcfg and bool(np.isfinite(outs["cuda"]).all()) and rel < 5e-2
        log(f"[ldm-bert] {sum(v.numel() for v in state.values()):.4e} parameters "
            f"({conf.num_layers} layers, d_model {conf.d_model}, {conf.num_heads}×"
            f"{conf.head_dim} heads), 77 tokens: card bf16 vs CPU f32 relative L2 {rel:.3e} "
            f"(tol 5e-2) {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"LDM-BERT {conf} {rel:.3e}")
        del state, pipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
        from pww_tpu_torch.pipeline import facade

        facade._PIPELINE_CACHE.clear()
        torch.cuda.empty_cache()
    if problems:
        raise SystemExit(f"[single] {problems}")
    return launches, profiled


def dir_gb(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs) / 1e9


def phase_tiny():
    """The tiny config (head dims 8 and 16, which K1-K3 are not built for)
    on the card: every attention site takes the dense path, no K1-K3
    launches (ROADMAP C.1); every norm site takes K4 or K5."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline

    pipe = PwwPipeline(SDModelConfig.tiny(), device="cuda")
    cm = np.zeros((128, 128, 3), np.uint8)
    cm[:, :64] = (255, 0, 0)
    cm[:, 64:] = (0, 0, 255)
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    lat = pipe.generate(prompt="a cat and a dog", color_map_image=cm,
                        color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
                        num_inference_steps=2, seed=0, return_latents=True)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = path_launches(2, (0, 0, 0), TINY_NORMS, decodes=0)
    ok = lat.shape == (1, 16, 16, 4) and bool(np.isfinite(lat).all()) and launches == want
    log(f"[tiny] SDModelConfig.tiny() on the card, 128 px, 2 steps: latents {lat.shape}, "
        f"finite {bool(np.isfinite(lat).all())}, launches {launches} "
        f"({want} wanted) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[tiny] the tiny config failed on the card or its launches differ")


def phase_sd2_reference():
    """Reduced-depth SD-2.1-width txt2img (layers_per_block 1, 2 CLIP layers,
    head dim 64, v-prediction), 256 px, 3 steps: card bf16 vs CPU f32, with
    the LMS (sigma-space) and DDIM (alpha-space) v-to-ε conversions."""
    import dataclasses

    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.schedulers.schedules import make_scheduler
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = SDModelConfig(clip=dataclasses.replace(CLIPTextConfig.sd21(), num_layers=2),
                        unet=dataclasses.replace(UNetConfig.sd21(), layers_per_block=1),
                        vae=VAEConfig.tiny())
    params = synthetic_params(cfg, seed=3, device="cuda", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    gpu_pipe = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16)
    del params
    cpu_pipe = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32)
    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    cm[:, 128:] = (0, 0, 255)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True)
    counters = launch_counters()[:3]
    failed = []
    for kind in ("lms", "ddim"):
        gpu_pipe.scheduler = cpu_pipe.scheduler = make_scheduler(kind)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        gpu = gpu_pipe.generate(**kw)
        launched = tuple(c.launches for c in counters)
        t1 = time.perf_counter()
        ref = cpu_pipe.generate(**kw)
        t2 = time.perf_counter()
        rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
        ok = bool(np.isfinite(gpu).all()) and rel < 5e-2 and min(launched) > 0
        log(f"[sd2 reference] {kind}, 256 px, 3 steps, SD-2.1-width UNet (layers_per_block "
            f"1, v-prediction; K1 {launched[0]}, K2 {launched[1]}, K3 {launched[2]} "
            f"launches): card bf16 vs CPU f32 relative L2 error {rel:.3e} (tol 5e-2), "
            f"latents std {ref.std():.3f}, card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(kind)
    del gpu_pipe, cpu_pipe, cpu
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"[sd2 reference] card run disagrees with the CPU reference: {failed}")


def sd21_color_map(size=768):
    import numpy as np

    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, :size // 2] = (255, 0, 0)
    cm[:, size // 2:] = (0, 0, 255)
    return cm


def phase_sd21(steps, card):
    """SD-2.1 768-v at full width through a diffusers directory: write it,
    load it through ``paint_with_words(local_model_path=...)``, run N LMS
    steps at 768² with the launch counts checked, check the loader's cache,
    profile a 5-step call, then one 4-step call per scheduler. The
    directory is deleted at the end."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words, pww_load_tools
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params
    from pww_tpu_torch.weights.loader import save_diffusers_checkpoint

    cfg = SDModelConfig.sd21()
    path = tempfile.mkdtemp(prefix="pww_sd21_")
    try:
        t0 = time.perf_counter()
        params = synthetic_params(cfg, seed=0, device="cuda", dtype=torch.float16)
        n_params = sum(v.numel() for sd in params.values() for v in sd.values())
        save_diffusers_checkpoint(path, cfg, params, synthetic_tokenizer(49408))
        del params
        torch.cuda.empty_cache()
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(path) for f in fs)
        t1 = time.perf_counter()
        pipe = pww_load_tools("cuda", "lms", local_model_path=path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"[sd21] SD-2.1 768-v, {n_params:.4e} synthetic parameters: diffusers directory "
            f"of {nbytes / 1e9:.3f} GB (fp16 safetensors) written in {t1 - t0:.1f} s, loaded "
            f"by pww_load_tools to the card in bf16 in {t2 - t1:.1f} s; head dims "
            f"{sorted({cfg.unet.heads_for(c)[1] for c in cfg.unet.block_out_channels})}, "
            f"prediction {pipe.config.unet.prediction_type}")
        pipe.profile = True
        kw = dict(local_model_path=path, device="cuda", scheduler_type="lms",
                  color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
                  color_map_image=sd21_color_map(),
                  input_prompt="a cat sitting next to a dog, realistic photo",
                  guidance_scale=7.5, seed=0, output_type="np")
        paint_with_words(num_inference_steps=2, **kw)  # warm-up
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = paint_with_words(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        tm = pipe.timings
        log(f"[sd21] paint_with_words 768², {steps} LMS steps, CFG 7.5: encode "
            f"{tm['encode']:.3f} s, denoise {tm['denoise']:.3f} s "
            f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s, "
            f"{total:.3f} s/image, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card})")
        log(f"[sd21] launches: {launches}")
        want = path_launches(steps)
        problems = []
        if img.shape != (1, 768, 768, 3) or img.dtype != np.uint8 or img.std() == 0:
            problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
        if launches != want:
            problems.append(f"launches {launches} != {want}")
        cached = pww_load_tools("cuda", "lms", local_model_path=path) is pipe
        if not cached:
            problems.append("pww_load_tools did not return the cached pipeline")
        log(f"[sd21] image {img.shape} {img.dtype} mean {img.mean():.2f} std "
            f"{img.std():.2f}; pww_load_tools returned the cached pipeline: {cached}")
        if problems:
            raise SystemExit(f"[sd21] {problems}")
        profiled = phase_profile(lambda n: paint_with_words(num_inference_steps=n, **kw),
                                 "sd21")
        if profiled["K1 pww_reduce"][1] != 1:
            raise SystemExit("[profile sd21] K1 is not one device kernel per call")
        phase_schedulers(pipe, kw)
        return launches, profiled
    finally:
        shutil.rmtree(path, ignore_errors=True)


def edge_hint(cm):
    """White where the color map changes between neighbours, black elsewhere:
    a ControlNet or T2I-Adapter hint drawn from the regions' outlines."""
    import numpy as np

    edge = np.zeros(cm.shape[:2], bool)
    dx = (cm[:, 1:] != cm[:, :-1]).any(-1)
    dy = (cm[1:] != cm[:-1]).any(-1)
    edge[:, 1:] |= dx
    edge[:, :-1] |= dx
    edge[1:] |= dy
    edge[:-1] |= dy
    return np.repeat(edge[..., None], 3, -1).astype(np.uint8) * 255


def phase_controlnet_reference():
    """Phase 4's reduced-depth SD-1.5-width txt2img with one ControlNet and
    one T2I-Adapter of that config: card bf16 vs CPU f32."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import PARTS, synthetic_params

    clip = CLIPTextConfig.tiny()
    cfg = SDModelConfig(
        clip=clip,
        unet=UNetConfig(block_out_channels=(320, 640), layers_per_block=1,
                        down_block_has_attn=(True, False), cross_attention_dim=clip.hidden_size),
        vae=VAEConfig.tiny(),
    )
    # std 0.1 in every tensor, the ControlNet's zero convs too, so that its
    # residuals are live
    params = synthetic_params(cfg, seed=4, device="cuda", dtype=torch.float32,
                              parts=PARTS + ("controlnet", "t2i_adapter"))
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    cm[:, 128:] = (0, 0, 255)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True,
              control_image=edge_hint(cm), controlnet_conditioning_scale=0.7,
              adapter_image=edge_hint(cm))
    counters = launch_counters()[:3]
    for c in counters:
        c.launches = 0
    gpu = (PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16)
           .load_controlnet(params=params["controlnet"])
           .load_t2i_adapter(params=params["t2i_adapter"]).generate(**kw))
    launched = [c.launches for c in counters]
    del params
    ref_pipe = (PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32)
                .load_controlnet(params=cpu["controlnet"])
                .load_t2i_adapter(params=cpu["t2i_adapter"]))
    ref = ref_pipe.generate(**kw)
    plain = ref_pipe.generate(**{k: v for k, v in kw.items()
                                 if k not in ("control_image", "adapter_image")})
    rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
    moved = float(np.linalg.norm(ref - plain) / np.linalg.norm(plain))
    # per visit: K1, K2 at the UNet's 4 and the ControlNet's 2 sites of Lq >=
    # 256 (32² and the 16² mid block), K3 at the 3 + 1 sites of L 1024
    ok = bool(np.isfinite(gpu).all()) and rel < 5e-2 and launched == [18, 18, 12]
    log(f"[controlnet reference] 256 px, 3 steps, (320, 640)-channel UNet with a ControlNet "
        f"(scale 0.7) and a T2I-Adapter of that config (K1/K2/K3 {launched} launches): card "
        f"bf16 vs CPU f32 relative L2 error {rel:.3e} (tol 5e-2); the hints move the CPU "
        f"latents by {moved:.3e} relative L2 {'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("[controlnet reference] card run disagrees with the CPU reference, "
                         "or the launch counts differ")


def phase_controlnet(steps, card):
    """SD-1.5 at full width with a full SD-1.5 ControlNet loaded from a
    diffusers directory: N LMS steps with the counts checked and a 5-step
    profile, then 4-step calls with two stacked ControlNets, the T2I-Adapter
    and the split path. The directory is deleted at the end."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params
    from pww_tpu_torch.weights.loader import save_controlnet_checkpoint

    cfg = SDModelConfig.sd15()
    pipe = PwwPipeline(cfg, params=synthetic_params(cfg, seed=0, device="cuda"),
                       tokenizer=synthetic_tokenizer(49408), device="cuda", profile=True)
    path = tempfile.mkdtemp(prefix="pww_controlnet_")
    try:
        t0 = time.perf_counter()
        # N(0, 0.02) in every tensor, the zero convs too, so the residuals are live
        state = synthetic_params(cfg, seed=1, device="cuda", parts=("controlnet",))["controlnet"]
        n_params = sum(v.numel() for v in state.values())
        save_controlnet_checkpoint(path, cfg, state)
        del state
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t1 = time.perf_counter()
        pipe.load_controlnet(source=path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"[controlnet] SD-1.5 ControlNet, {n_params:.4e} synthetic parameters: diffusers "
            f"directory of {nbytes / 1e9:.3f} GB (bf16 safetensors) written in {t1 - t0:.1f} s, "
            f"loaded by load_controlnet(source=...) to the card in {t2 - t1:.1f} s")
        cm = np.zeros((512, 512, 3), np.uint8)
        cm[:, :256] = (255, 0, 0)
        cm[:, 256:] = (0, 0, 255)
        hint = edge_hint(cm)
        kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
                  color_map_image=cm, input_prompt="a cat sitting next to a dog, realistic photo",
                  guidance_scale=7.5, seed=0, preloaded_utils=pipe, device="cuda",
                  output_type="np")
        paint_with_words(num_inference_steps=2, control_image=hint, **kw)  # warm-up
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = paint_with_words(num_inference_steps=steps, control_image=hint, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        tm = pipe.timings
        log(f"[controlnet] paint_with_words 512², {steps} LMS steps, CFG 7.5, one ControlNet: "
            f"encode {tm['encode']:.3f} s, denoise {tm['denoise']:.3f} s "
            f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s, "
            f"{total:.3f} s/image, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card})")
        log(f"[controlnet] launches: {launches}")
        plain = paint_with_words(num_inference_steps=steps, **kw)
        want = path_launches(steps, (21, 21, 14), net=CONTROLNET_NORMS)
        diff = np.abs(img.astype(int) - plain.astype(int))
        problems = []
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
            problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
        if launches != want:
            problems.append(f"launches {launches} != {want}")
        if not diff.any():
            problems.append("the image equals the one without control_image")
        log(f"[controlnet] image {img.shape} {img.dtype} mean {img.mean():.2f} std "
            f"{img.std():.2f}; against the image without control_image: mean |diff| "
            f"{diff.mean():.2f}, {(diff > 0).mean():.3f} of the values differ")
        if problems:
            raise SystemExit(f"[controlnet] {problems}")
        profiled = phase_profile(lambda n: paint_with_words(num_inference_steps=n,
                                                            control_image=hint, **kw),
                                 "controlnet")
        if profiled["K1 pww_reduce"][1] != 1:
            raise SystemExit("[profile controlnet] K1 is not one device kernel per call")
        phase_controlnet_variants(pipe, kw, hint)
        return launches, profiled
    finally:
        shutil.rmtree(path, ignore_errors=True)


def phase_controlnet_variants(pipe, kw, hint, steps=4):
    """4-step calls on the ControlNet pipeline: two stacked nets, the
    T2I-Adapter alone, and one net on the split path (a custom weight
    function); launches per visit and finite outputs checked."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.weights.bridge import synthetic_params

    def custom(w, sigma, qk):  # the default function, as a callable: the split path
        return 0.1 * w * torch.log1p(sigma) * torch.amax(qk)

    single = pipe.controlnets
    second = synthetic_params(SDModelConfig.sd15(), seed=2, device="cuda",
                              parts=("controlnet",))["controlnet"]
    pipe.add_controlnet(params=second)
    del second
    pipe.load_t2i_adapter(seed=3)
    plain = paint_with_words(num_inference_steps=steps, **kw)
    cases = (  # name, generate's arguments, launches K1/K2/K3 per visit, ControlNets
        ("two ControlNets", dict(control_image=[hint, hint],
                                 controlnet_conditioning_scale=[1.0, 0.5]), (27, 27, 18), 2),
        ("T2I-Adapter", dict(adapter_image=hint), (15, 15, 10), 2),
        ("split path, one ControlNet", dict(control_image=hint, weight_function=custom),
         (0, 0, 28), 1),
    )
    counters = launch_counters()[:3]
    failed = []
    for name, extra, per_visit, nets in cases:
        pipe.controlnets = pipe.controlnets[:nets]
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        img = paint_with_words(num_inference_steps=steps, **kw, **extra)
        torch.cuda.synchronize()
        launched = [c.launches for c in counters]
        ok = (img.std() > 0 and launched == [n * steps for n in per_visit]
              and (name != "T2I-Adapter" or not np.array_equal(img, plain)))
        log(f"[controlnet] {name}: {steps} steps, launches K1/K2/K3 {launched} "
            f"({[n * steps for n in per_visit]} wanted), mean |diff| against no control "
            f"{np.abs(img.astype(int) - plain.astype(int)).mean():.2f}, "
            f"{time.perf_counter() - t0:.3f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    pipe.controlnets, pipe.t2i_adapter = single, None
    if failed:
        raise SystemExit(f"[controlnet] {failed}")


def phase_schedulers(pipe, kw, steps=4):
    """One ``steps``-step call per scheduler kind (and DPM++ 2M with Karras
    sigmas) on the SD-2.1 pipeline: finite latents, and K1 = K2 = 15 and
    K3 = 10 launches per visit of the denoise loop."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SchedulerConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words
    from pww_tpu_torch.schedulers.schedules import KINDS, make_scheduler

    run_kw = {k: v for k, v in kw.items() if k not in ("local_model_path", "scheduler_type",
                                                       "output_type")}
    cases = [(k, SchedulerConfig()) for k in KINDS]
    cases.append(("dpmpp_2m", SchedulerConfig(use_karras_sigmas=True)))
    counters = launch_counters()[:3]
    failed = []
    lms = pipe.scheduler
    try:
        for kind, scfg in cases:
            pipe.scheduler = make_scheduler(kind, scfg)
            visits = pipe.scheduler.set_timesteps(steps).num_steps
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            lat = paint_with_words(num_inference_steps=steps, preloaded_utils=pipe,
                                   return_latents=True, **run_kw)
            torch.cuda.synchronize()
            launched = [c.launches for c in counters]
            ok = (bool(np.isfinite(lat).all()) and lat.shape == (1, 96, 96, 4)
                  and launched == [15 * visits, 15 * visits, 10 * visits])
            name = kind + (" karras" if scfg.use_karras_sigmas else "")
            log(f"[schedulers] {name}: {steps} steps, {visits} visits, launches K1/K2/K3 "
                f"{launched}, latents |max| {np.abs(lat).max():.3f}, "
                f"{time.perf_counter() - t0:.3f} s {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(name)
    finally:
        pipe.scheduler = lms
    if failed:
        raise SystemExit(f"[schedulers] {failed}")


def xl_reduced_configs():
    """SDXL base and refiner at their published widths (channels, head dim
    64, both text towers), cut in depth: layers_per_block 1, transformer
    depth 2 where there is attention, 2 layers per tower, the tiny VAE."""
    import dataclasses

    from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig, UNetConfig, VAEConfig

    vae = dataclasses.replace(VAEConfig.tiny(), scaling_factor=0.13025)
    base = SDModelConfig.sdxl()
    base = dataclasses.replace(
        base, clip=dataclasses.replace(CLIPTextConfig.sdxl_l(), num_layers=2),
        clip2=dataclasses.replace(CLIPTextConfig.sdxl_bigg(), num_layers=2),
        unet=dataclasses.replace(UNetConfig.sdxl(), layers_per_block=1,
                                 transformer_depth=(0, 2, 2)), vae=vae)
    refiner = SDModelConfig.sdxl_refiner()
    refiner = dataclasses.replace(
        refiner, clip=dataclasses.replace(refiner.clip, num_layers=2),
        unet=dataclasses.replace(refiner.unet, layers_per_block=1,
                                 transformer_depth=(0, 2, 2, 2)), vae=vae)
    return base, refiner


def phase_sdxl_reference():
    """The reduced SDXL base (xl_reduced_configs) at 512², 3 LMS steps, card
    bf16 vs CPU f32; then a 6-step trajectory cut at 0.5 (3 visits each):
    the base to ``denoising_end``, the reduced refiner from
    ``denoising_start`` on each device's own base latents, and the card's
    refiner from the CPU's base latents, whose update (output minus those
    latents) is held against the CPU's update, so that the refiner's own
    error is not hidden under what it inherits."""
    import numpy as np
    import torch

    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import synthetic_params

    base_cfg, ref_cfg = xl_reduced_configs()
    pipes = {}
    for name, cfg, seed in (("base", base_cfg, 5), ("refiner", ref_cfg, 6)):
        params = synthetic_params(cfg, seed=seed, device="cuda", dtype=torch.float32)
        params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
        cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
        pipes[name] = (PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16),
                       PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32))
        del params, cpu
    cm = sd21_color_map(512)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              seed=0, return_latents=True)
    counters = launch_counters()[:3]
    # per visit at 512² (latent 64²): the base's 32² stage (Lq 1024: 2 down
    # and 4 up sites, K1-K3) and 16² stage (Lq 256: 2 down, 2 mid, 4 up, K1
    # and K2); the refiner's 32² stage (6, K1-K3) and 16² stage (6, K1 and
    # K2), its 8² mid block dense
    per_visit = {"base": (14, 14, 6), "refiner": (12, 12, 6)}
    cases = (  # label, model, generate's arguments, visits, init latents from
        ("base", "base", dict(num_inference_steps=3), 3, None),
        ("base denoising_end=0.5", "base", dict(num_inference_steps=6, denoising_end=0.5),
         3, None),
        ("refiner denoising_start=0.5", "refiner",
         dict(num_inference_steps=6, denoising_start=0.5), 3, "own"),
        ("refiner denoising_start=0.5 from the CPU's latents, its update", "refiner",
         dict(num_inference_steps=6, denoising_start=0.5), 3, "cpu"),
    )
    failed, lats, ref = [], {}, None
    for label, name, extra, visits, init in cases:
        gpu_pipe, cpu_pipe = pipes[name]
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        start = {"own": lats.get("gpu"), "cpu": lats.get("cpu")}.get(init)
        gpu = gpu_pipe.generate(**kw, **extra, **({} if init is None
                                                  else {"init_latents": start}))
        launched = [c.launches for c in counters]
        t1 = time.perf_counter()
        if init != "cpu":  # the CPU run of the update case is the one before it
            ref = cpu_pipe.generate(**kw, **extra, **({} if init is None
                                                      else {"init_latents": lats["cpu"]}))
        t2 = time.perf_counter()
        if "denoising_end" in extra:
            lats = {"gpu": gpu, "cpu": ref}
        got, want = (gpu - start, ref - start) if init == "cpu" else (gpu, ref)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        expect = [n * visits for n in per_visit[name]]
        ok = bool(np.isfinite(gpu).all()) and rel < 5e-2 and launched == expect
        log(f"[sdxl reference] {label}, 512², {visits} LMS visits, SDXL widths (layers 1, "
            f"depth 2, 2-layer towers; K1/K2/K3 {launched}, {expect} wanted): card bf16 vs "
            f"CPU f32 relative L2 error {rel:.3e} (tol 5e-2), |want| {np.linalg.norm(want):.1f}, "
            f"card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    del pipes
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"[sdxl reference] card run disagrees with the CPU reference, or the "
                         f"launch counts differ: {failed}")


def xl_directory(cfg, seed, tag):
    """Write a synthetic fp16 diffusers directory of ``cfg`` to a temporary
    directory, after printing the free space there; returns (path, number
    of parameters, GB written, write s)."""
    import shutil
    import tempfile

    import torch

    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params
    from pww_tpu_torch.weights.loader import save_diffusers_checkpoint

    free = shutil.disk_usage(tempfile.gettempdir()).free
    log(f"[sdxl] {tag}: {free / 1e9:.1f} GB free in {tempfile.gettempdir()}")
    path = tempfile.mkdtemp(prefix=f"pww_{tag}_")
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=seed, device="cuda", dtype=torch.float16)
    n_params = sum(v.numel() for sd in params.values() for v in sd.values())
    save_diffusers_checkpoint(path, cfg, params, synthetic_tokenizer(49408))
    del params
    torch.cuda.empty_cache()
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    return path, n_params, nbytes / 1e9, time.perf_counter() - t0


def load_xl(cfg, seed, tag):
    """``xl_directory``, then ``pww_load_tools`` on it; the directory is
    deleted once the pipeline is on the card (the loader's cache keeps it)."""
    import shutil

    import torch

    from pww_tpu_torch.pipeline.facade import pww_load_tools

    path, n_params, gb, write_s = xl_directory(cfg, seed, tag)
    try:
        t0 = time.perf_counter()
        pipe = pww_load_tools("cuda", "lms", local_model_path=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    log(f"[sdxl] {tag}, {n_params:.4e} synthetic parameters: diffusers directory of "
        f"{gb:.3f} GB (fp16 safetensors) written in {write_s:.1f} s, loaded by pww_load_tools "
        f"to the card in bf16 in {load_s:.1f} s, then deleted")
    return pipe, path


def phase_sdxl(steps, card, enc_dir, tmp):
    """SDXL-base at diffusers' published shapes from a written directory,
    through ``paint_with_words(local_model_path=...)``: N LMS steps at 1024²
    with 70 launches of each of K1-K3 per visit, the loader's cache, a
    5-step profile; then the refiner at its published shapes the same way,
    one ensemble call (base ``denoising_end=0.8``, refiner ``init_latents``
    and ``denoising_start=0.8``) with launches checked per model, and one
    euler call on the base; then the adapters on the base
    (phase_sdxl_adapters)."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words, pww_load_tools
    from pww_tpu_torch.schedulers.schedules import make_scheduler

    base_cfg, ref_cfg = SDModelConfig.sdxl(), SDModelConfig.sdxl_refiner()
    pipe, path = load_xl(base_cfg, 0, "sdxl")
    pipe.profile = True
    kw = dict(local_model_path=path, device="cuda", scheduler_type="lms",
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=sd21_color_map(1024),
              input_prompt="a cat sitting next to a dog, realistic photo",
              guidance_scale=7.5, seed=0, output_type="np")
    paint_with_words(num_inference_steps=2, **kw)  # warm-up
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = paint_with_words(num_inference_steps=steps, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    tm = pipe.timings
    log(f"[sdxl] paint_with_words 1024², {steps} LMS steps, CFG 7.5: encode "
        f"{tm['encode']:.3f} s, denoise {tm['denoise']:.3f} s "
        f"({tm['denoise'] / steps * 1e3:.1f} ms/step), decode {tm['decode']:.3f} s, "
        f"{total:.3f} s/image, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card})")
    log(f"[sdxl] launches: {launches}")
    want = path_launches(steps, SDXL_LAUNCHES_PER_VISIT["sdxl"], SDXL_NORMS)
    problems = []
    if img.shape != (1, 1024, 1024, 3) or img.dtype != np.uint8 or img.std() == 0:
        problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    cached = pww_load_tools("cuda", "lms", local_model_path=path) is pipe
    if not cached:
        problems.append("pww_load_tools did not return the cached pipeline")
    log(f"[sdxl] image {img.shape} {img.dtype} mean {img.mean():.2f} std {img.std():.2f}; "
        f"pww_load_tools returned the cached pipeline: {cached}")
    if problems:
        raise SystemExit(f"[sdxl] {problems}")
    profiled = phase_profile(lambda n: paint_with_words(num_inference_steps=n, **kw), "sdxl")
    if profiled["K1 pww_reduce"][1] != 1:
        raise SystemExit("[profile sdxl] K1 is not one device kernel per call")

    refiner, ref_path = load_xl(ref_cfg, 1, "sdxl_refiner")
    refiner.profile = True
    run_kw = {k: v for k, v in kw.items() if k not in ("local_model_path", "scheduler_type",
                                                       "output_type", "device")}
    prompt = run_kw.pop("input_prompt")
    cutoff_visits = steps_at_or_above(pipe, steps, 0.8)
    refiner.generate(prompt=prompt, num_inference_steps=4, init_latents=pipe.generate(
        prompt=prompt, num_inference_steps=4, denoising_end=0.8, return_latents=True,
        **run_kw), denoising_start=0.8, output_type="np", **run_kw)  # warm-up
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lat = paint_with_words(num_inference_steps=steps, denoising_end=0.8, return_latents=True,
                           **kw)
    base_launches = [c.launches for c in counters[:3]]
    for c in counters:
        c.launches = 0
    img = refiner.generate(prompt=prompt, num_inference_steps=steps, init_latents=lat,
                           denoising_start=0.8, output_type="np", **run_kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    ref_launches = [c.launches for c in counters[:3]]
    want_base = [n * cutoff_visits for n in SDXL_LAUNCHES_PER_VISIT["sdxl"]]
    want_ref = [n * (steps - cutoff_visits) for n in SDXL_LAUNCHES_PER_VISIT["sdxl_refiner"]]
    ok = (base_launches == want_base and ref_launches == want_ref and img.std() > 0
          and img.shape == (1, 1024, 1024, 3) and bool(np.isfinite(lat).all()))
    log(f"[sdxl] ensemble, {steps} LMS steps: the base {cutoff_visits} visits (K1/K2/K3 "
        f"{base_launches}, {want_base} wanted), the refiner {steps - cutoff_visits} from "
        f"its latents (K1/K2/K3 {ref_launches}, {want_ref} wanted), {total:.3f} s/image, "
        f"refiner denoise {refiner.timings['denoise']:.3f} s, decode "
        f"{refiner.timings['decode']:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; image std {img.std():.2f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[sdxl] the ensemble call failed its launch or output checks")
    del refiner
    torch.cuda.empty_cache()
    lms = pipe.scheduler
    pipe.scheduler = make_scheduler("euler")
    try:
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        lat = paint_with_words(num_inference_steps=4, preloaded_utils=pipe, return_latents=True,
                               **{k: v for k, v in kw.items() if k != "local_model_path"})
        torch.cuda.synchronize()
        launched = [c.launches for c in counters[:3]]
    finally:
        pipe.scheduler = lms
    want = [n * 4 for n in SDXL_LAUNCHES_PER_VISIT["sdxl"]]
    ok = launched == want and lat.shape == (1, 128, 128, 4) and bool(np.isfinite(lat).all())
    log(f"[sdxl] euler, 4 steps: launches K1/K2/K3 {launched} ({want} wanted), latents "
        f"|max| {np.abs(lat).max():.3f}, {time.perf_counter() - t0:.3f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[sdxl] the euler call failed its launch or output checks")
    controlnet = phase_sdxl_controlnet(pipe, dict(run_kw, prompt=prompt), card, tmp)
    adapters = phase_sdxl_adapters(pipe, dict(run_kw, prompt=prompt), card, enc_dir, tmp)
    return (launches, profiled, {"base": base_launches, "refiner": ref_launches}, adapters,
            controlnet)


# -- the JAX package's noise, the SDXL ControlNet and SDXL inpainting ---------------------

def phase_jax_random():
    """The host threefry (``pww_tpu_torch/utils/jax_random.py``) against
    JAX_KNOWN_ANSWERS, then the host ms of the draws a call makes: one SDXL
    latent, a batch-8 512² latent, and one batch-8 ancestral step's noise
    (eight per-request streams, as ``generate_batch`` draws them)."""
    import numpy as np
    import torch

    from pww_tpu_torch.conditioning.seeding import make_noise
    from pww_tpu_torch.schedulers.schedules import step_noise
    from pww_tpu_torch.utils import jax_random as jr

    k = jr.PRNGKey(0)
    got = {"normal": jr.normal(k, (4,)).tolist(), "bits": jr.bits(k, (4,)).tolist(),
           "split": jr.split(k).tolist(), "fold_in": jr.fold_in(k, 7).tolist(),
           "randint": jr.randint(k, (4,), 0, 1000).tolist(),
           "bf16_normal": jr.normal(k, (4,), "bfloat16").tolist()}
    # f32 normals within 1e-6 (XLA's log1p is not numpy's), the rest equal
    bad = [name for name, want in JAX_KNOWN_ANSWERS.items()
           if (np.abs(np.subtract(got[name], want)).max() > 1e-6 if name == "normal"
               else got[name] != want)]
    log(f"[jax random] PRNGKey(0): normal {got['normal']}, bits {got['bits']}, split "
        f"{got['split']}, fold_in(7) {got['fold_in']}, randint [0, 1000) {got['randint']}, "
        f"bf16 normal {got['bf16_normal']}: {'ok' if not bad else f'FAIL {bad}'}")
    if bad:
        raise SystemExit(f"[jax random] the host draws differ from jax.random: {bad}")
    draws = {
        "SDXL latent (1, 4, 128, 128)": lambda: make_noise(0, (1, 4, 128, 128), "jax", "cuda"),
        "batch-8 512² latent (8, 4, 64, 64)": lambda: make_noise(0, (8, 4, 64, 64), "jax",
                                                                  "cuda"),
        "batch-8 ancestral step noise": lambda: step_noise(range(8), 5, (8, 4, 64, 64), "cuda"),
    }
    ms = {}
    for label, fn in draws.items():
        fn()
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[label] = statistics.median(times)
    log("[jax random] host ms per draw (median of 7, to the card): " + ", ".join(
        f"{label} {t:.3f}" for label, t in ms.items()))
    return ms


def xl_reduced_pipes(cfg, seed, parts=None):
    """(card bf16, CPU f32) pipelines of ``cfg`` on the same synthetic
    weights, std 0.1 in every tensor (a ControlNet's zero convs too)."""
    import torch

    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import pipeline_parts, synthetic_params

    params = synthetic_params(cfg, seed=seed, device="cuda", dtype=torch.float32,
                              parts=pipeline_parts(cfg) + tuple(parts or ()))
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    cpu = {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()}
    gpu_pipe = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16)
    cpu_pipe = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32)
    if parts and "controlnet" in parts:
        gpu_pipe.load_controlnet(params=params["controlnet"])
        cpu_pipe.load_controlnet(params=cpu["controlnet"])
    return gpu_pipe, cpu_pipe


def phase_sdxl_controlnet_reference():
    """xl_reduced_configs' base with a ControlNet of that config (SDXL's:
    text_time, its own add_embedding) at 512², 3 LMS steps, the color map's
    edges as the hint at scale 0.7, card bf16 vs CPU f32, on the batched
    CFG path and on the split one (each half's added_cond to the net)."""
    import numpy as np
    import torch

    base_cfg, _ = xl_reduced_configs()
    gpu_pipe, cpu_pipe = xl_reduced_pipes(base_cfg, 7, ("controlnet",))
    cm = sd21_color_map(512)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True,
              control_image=edge_hint(cm), controlnet_conditioning_scale=0.7)
    counters = launch_counters()[:3]
    per_visit = [a + b for a, b in zip(*XL_REDUCED_VISIT.values())]
    failed = []
    for label, extra, want_launches in (
            ("batched", {}, [n * 3 for n in per_visit]),
            ("split", dict(weight_function=lambda w, sigma, qk: 0.4 * w * torch.log1p(sigma)),
             [0, 0, 2 * 3 * per_visit[2]])):
        for c in counters:
            c.launches = 0
        gpu = gpu_pipe.generate(**kw, **extra)
        launched = [c.launches for c in counters]
        ref = cpu_pipe.generate(**kw, **extra)
        rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
        moved = ""
        ok = bool(np.isfinite(gpu).all()) and rel < 5e-2 and launched == want_launches
        if not extra:  # that the net is live, once
            plain = cpu_pipe.generate(**{k: v for k, v in kw.items() if k != "control_image"})
            shift = float(np.linalg.norm(ref - plain) / np.linalg.norm(plain))
            ok = ok and shift > 1e-3
            moved = f"; the hint moves the CPU latents by {shift:.3e}"
        log(f"[sdxl controlnet reference] {label}, 512², 3 LMS steps, SDXL widths cut in depth "
            f"with an SDXL ControlNet of that config (K1/K2/K3 {launched}, {want_launches} "
            f"wanted): card bf16 vs CPU f32 relative L2 error {rel:.3e} (tol 5e-2){moved} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    del gpu_pipe, cpu_pipe
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"[sdxl controlnet reference] card run disagrees with the CPU "
                         f"reference, or the launch counts differ: {failed}")


def phase_sdxl_controlnet(pipe, gkw, card, tmp, steps=4):
    """On phase 19's SDXL base: an SDXL ControlNet at diffusers' published
    shapes (SDXL_CONTROLNET_PARAMS) written as an fp16 diffusers directory
    and attached by ``load_controlnet(path)``, then ``steps`` LMS steps at
    1024² with the color map's edges as the hint: K1 = K2 = K3 = (70 + 34)
    a visit, the image unlike the plain one, s/image, peak GiB, a 3-step
    profile. The net is detached and its directory deleted at the end."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.weights.bridge import synthetic_params
    from pww_tpu_torch.weights.loader import save_controlnet_checkpoint

    path = os.path.join(tmp, "sdxl_controlnet")
    t0 = time.perf_counter()
    state = synthetic_params(SDModelConfig.sdxl(), seed=3, device="cuda", dtype=torch.float16,
                             parts=("controlnet",))["controlnet"]
    n_params = sum(v.numel() for v in state.values())
    save_controlnet_checkpoint(path, SDModelConfig.sdxl(), state)
    del state
    gb = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9
    t1 = time.perf_counter()
    pipe.load_controlnet(source=path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    shutil.rmtree(path, ignore_errors=True)
    log(f"[sdxl controlnet] SDXL ControlNet, {n_params} synthetic parameters "
        f"({SDXL_CONTROLNET_PARAMS} wanted): diffusers directory of {gb:.3f} GB (fp16 "
        f"safetensors, text_time) written in {t1 - t0:.1f} s, loaded by "
        f"load_controlnet(source=...) to the card in {t2 - t1:.1f} s, then deleted")
    hint = edge_hint(gkw["color_map_image"])
    kw = dict(gkw, output_type="np", control_image=hint, controlnet_conditioning_scale=0.7)
    counters = launch_counters()
    try:
        pipe.generate(**dict(kw, num_inference_steps=2))  # warm-up
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = pipe.generate(num_inference_steps=steps, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        tm = pipe.timings
        plain = pipe.generate(num_inference_steps=steps,
                              **{k: v for k, v in kw.items() if k != "control_image"})
        per_visit = [a + b for a, b in zip(SDXL_LAUNCHES_PER_VISIT["sdxl"],
                                           SDXL_CONTROLNET_LAUNCHES_PER_VISIT)]
        want = path_launches(steps, per_visit, SDXL_NORMS, net=SDXL_CONTROLNET_NORMS)
        diff = np.abs(img.astype(int) - plain.astype(int))
        log(f"[sdxl controlnet] generate 1024², {steps} LMS steps, CFG 7.5, the SDXL ControlNet "
            f"at 0.7: denoise {tm['denoise']:.3f} s ({tm['denoise'] / steps * 1e3:.1f} "
            f"ms/step), {total:.3f} s/image, peak {peak:.2f} GiB ({card}); launches "
            f"{launches}; against the image without the hint: mean |diff| {diff.mean():.2f}")
        problems = []
        if n_params != SDXL_CONTROLNET_PARAMS:
            problems.append(f"{n_params} parameters")
        if img.shape != (1, 1024, 1024, 3) or img.dtype != np.uint8 or img.std() == 0:
            problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
        if launches != want:
            problems.append(f"launches {launches} != {want}")
        if not diff.any():
            problems.append("the image equals the one without control_image")
        if problems:
            raise SystemExit(f"[sdxl controlnet] {problems}")
        profiled = phase_profile(lambda n: pipe.generate(num_inference_steps=n, **kw),
                                 "sdxl controlnet", steps=3)
        if profiled["K1 pww_reduce"][1] != 1:
            raise SystemExit("[profile sdxl controlnet] K1 is not one device kernel per call")
    finally:
        pipe.controlnets = []
        torch.cuda.empty_cache()
    return launches, profiled


def xl_inpaint_config(cfg):
    """``cfg`` with a 9-channel UNet and the norm knobs on in the UNet and
    the VAE."""
    import dataclasses

    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, in_channels=9, fused_group_norm=True,
                                      fused_layer_norm=True),
        vae=dataclasses.replace(cfg.vae, fused_group_norm=True))


def phase_sdxl_inpaint_reference():
    """xl_reduced_configs' base as a 9-channel inpainting UNet with the norm
    knobs on, 512², 3 LMS steps at strength 1.0 (the posterior mean, since
    the card draws the sample in bf16 and the CPU in f32), card bf16 vs
    CPU f32; K4 and K5 must launch on the card."""
    import numpy as np
    import torch

    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    base_cfg, _ = xl_reduced_configs()
    gpu_pipe, cpu_pipe = xl_reduced_pipes(xl_inpaint_config(base_cfg), 8)
    cm = sd21_color_map(512)
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cm,
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              init_image=synthetic_init_image(512), mask_image=box_mask(512), strength=1.0,
              num_inference_steps=3, seed=0, vae_sample_mode="mean", return_latents=True)
    gn.group_norm.launches = ln.layer_norm.launches = 0
    gpu = gpu_pipe.generate(**kw)
    launched = (gn.group_norm.launches, ln.layer_norm.launches)
    ref = cpu_pipe.generate(**kw)
    rel = float(np.linalg.norm(gpu - ref) / np.linalg.norm(ref))
    ok = bool(np.isfinite(gpu).all()) and rel < 5e-2 and min(launched) > 0
    log(f"[sdxl inpaint reference] 512², 3 LMS steps, SDXL widths cut in depth, 9-channel, "
        f"norm kernels on (K4 {launched[0]}, K5 {launched[1]} launches): card bf16 vs CPU f32 "
        f"relative L2 error {rel:.3e} (tol 5e-2) {'ok' if ok else 'FAIL'}")
    del gpu_pipe, cpu_pipe
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("[sdxl inpaint reference] card run disagrees with the CPU reference")


def phase_sdxl_inpaint(card, steps=4):
    """SDXL-inpainting at diffusers' published shapes (a 9-channel SDXL-base
    UNet, synthetic weights, the norm knobs on in the UNet and the VAE)
    through ``paint_with_words_inpaint``, 1024², ``steps`` LMS steps at
    strength 1.0: one recorded step's K4/K5 signatures against XL_K4_SITES
    and XL_K5_SITES, then K1 = K2 = K3 = 70·N, K4 = 46·N + 2·22 + 30,
    K5 = 210·N, s/image, peak GiB and a 2-step profile (K1 and K4 one device
    kernel per call)."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.facade import paint_with_words_inpaint
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
    from pww_tpu_torch.weights.bridge import synthetic_params

    cfg = xl_inpaint_config(SDModelConfig.sdxl())
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=4, device="cuda", dtype=torch.bfloat16)
    pipe = PwwPipeline(cfg, params=params, tokenizer=synthetic_tokenizer(49408),
                       device="cuda", dtype=torch.bfloat16, profile=True)
    del params
    torch.cuda.synchronize()
    log(f"[sdxl inpaint] SDXL-inpainting (conv_in {pipe.unet.conv_in.in_channels} channels), "
        f"fused_group_norm and fused_layer_norm on, set up in {time.perf_counter() - t0:.1f} s")
    kw = dict(color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              color_map_image=sd21_color_map(1024), init_image=synthetic_init_image(1024),
              mask_image=box_mask(1024), input_prompt="a cat sitting next to a dog",
              guidance_scale=7.5, seed=0, strength=1.0, preloaded_utils=pipe, device="cuda",
              output_type="np")
    record_norm_sites(kw, XL_K4_SITES, XL_K5_SITES, "sdxl inpaint")  # also the warm-up
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = paint_with_words_inpaint(num_inference_steps=steps, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    k1, k2, k3 = SDXL_LAUNCHES_PER_VISIT["sdxl"]
    want = {"fused_pww_reduce": k1 * steps, "fused_pww_cross_attention": k2 * steps,
            "flash_self_attention": k3 * steps,
            "group_norm": sum(k4_calls(s, steps, table=XL_K4_SITES) for s in XL_K4_SITES),
            "layer_norm": sum(XL_K5_SITES.values()) * steps}
    log(f"[sdxl inpaint] paint_with_words_inpaint 1024², {steps} LMS steps, strength 1.0, CFG "
        f"7.5: encode {tm['encode']:.3f} s (two VAE encodes included), denoise "
        f"{tm['denoise']:.3f} s ({tm['denoise'] / steps * 1e3:.1f} ms/step), decode "
        f"{tm['decode']:.3f} s, {total:.3f} s/image, peak {peak:.2f} GiB ({card}); launches "
        f"{launches}")
    problems = []
    if img.shape != (1, 1024, 1024, 3) or img.dtype != np.uint8 or img.std() == 0:
        problems.append(f"image {img.shape} {img.dtype} std {img.std():.2f}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if problems:
        raise SystemExit(f"[sdxl inpaint] {problems}")
    profiled = phase_profile(lambda n: paint_with_words_inpaint(num_inference_steps=n, **kw),
                             "sdxl inpaint", steps=2)
    for group in ("K1 pww_reduce", "K4 group_norm"):
        if profiled[group][1] != 1:
            raise SystemExit(f"[profile sdxl inpaint] {group} is not one device kernel per call")
    del pipe
    torch.cuda.empty_cache()
    return launches, profiled


# -- the adapters: LoRA and the IP-Adapter (ROADMAP A.15, A.17c) ------------------------

# kohya's module selection: UNet attention and feed-forward linears, the
# transformers' 1×1 proj convs, LoCon 3×3 entries on every resnet conv, and
# the text towers' attention and MLP linears
LORA_UNET_LINEAR = r"attn[12]\.(to_q|to_k|to_v|to_out\.0)\.weight$|ff\.net\.(0\.proj|2)\.weight$"
LORA_UNET_PROJ = r"attentions\.\d+\.proj_(in|out)\.weight$"
LORA_UNET_CONV = r"resnets\.\d+\.conv[12]\.weight$"
LORA_UNET_ATTN = r"attn[12]\.(to_q|to_k|to_v|to_out\.0)\.weight$"
LORA_TE = r"self_attn\.(q|k|v|out)_proj\.weight$|mlp\.fc[12]\.weight$"
LORA_TE_ATTN = r"self_attn\.(q|k|v|out)_proj\.weight$"
KOHYA_PREFIX = {"unet": "lora_unet", "clip": "lora_te", "clip2": "lora_te2"}
PEFT_PREFIX = {"unet": "unet", "clip": "text_encoder", "clip2": "text_encoder_2"}


def lora_files(states, patterns, rank, alpha, seed, xl=False, std=0.02):
    """A LoRA for ``states`` ({tower: state dict}) on every weight matching
    ``patterns`` ({tower: regex}): N(0, std) halves drawn on the card from
    ``seed``, fp16, rank ``rank`` (conv entries: (r, I, kh, kw) down,
    (O, r, 1, 1) up). Returns (kohya layout with ``alpha``, peft layout with
    alpha/r folded into an f32 lora_B, a power of two here, so that both
    merge bit-equal) as CPU state dicts."""
    import torch

    assert (alpha / rank) in (0.5, 1.0, 2.0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kohya, peft = {}, {}
    prefix = dict(KOHYA_PREFIX, clip="lora_te1" if xl else "lora_te")
    for tower, sd in states.items():
        for key, w in sd.items():
            if not re.search(patterns.get(tower, "^$"), key):
                continue
            o, i = w.shape[:2]
            down_shape = (rank, i, *w.shape[2:])
            up_shape = (o, rank) + ((1, 1) if w.dim() == 4 else ())
            down = (torch.randn(down_shape, generator=g, device="cuda") * std).half().cpu()
            up = (torch.randn(up_shape, generator=g, device="cuda") * std).half().cpu()
            mod = key[: -len(".weight")]
            name = f"{prefix[tower]}_{mod.replace('.', '_')}"
            kohya.update({f"{name}.lora_down.weight": down, f"{name}.lora_up.weight": up,
                          f"{name}.alpha": torch.tensor(float(alpha), dtype=torch.float16)})
            # lora_B in f32: halving fp16 would round its subnormals
            peft.update({f"{PEFT_PREFIX[tower]}.{mod}.lora_A.weight": down,
                         f"{PEFT_PREFIX[tower]}.{mod}.lora_B.weight": up.float() * (alpha / rank)})
    return kohya, peft


def ip_adapter_file_state(unet, embed_dim, num_tokens=4, plus=None, seed=0, std=0.02,
                          device="cuda"):
    """An IP-Adapter for ``unet`` (the port's UNet), tencent-ailab's flat
    layout in fp16: the standard ``image_proj`` (proj to ``num_tokens``
    context tokens, its LayerNorm at 1 and 0) or, with ``plus`` = (dim,
    depth, heads, queries), a Resampler over ``embed_dim``-wide states with
    (1, Q, D) latents as published; ``to_k_ip``/``to_v_ip`` at every attn2
    site, N(0, std) from ``seed`` on ``device``."""
    import torch

    from pww_tpu_torch.weights.ip_adapter import attn2_sites, site_module

    g = torch.Generator(device=device).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=device) * std).half().cpu()

    ctx = unet.config.cross_attention_dim
    if plus is None:
        proj = {"proj.weight": w(num_tokens * ctx, embed_dim), "proj.bias": w(num_tokens * ctx),
                "norm.weight": torch.ones(ctx).half(), "norm.bias": torch.zeros(ctx).half()}
    else:
        dim, depth, heads, queries = plus
        inner = heads * 64
        ones, zeros = torch.ones(dim).half(), torch.zeros(dim).half()
        proj = {"latents": w(1, queries, dim), "proj_in.weight": w(dim, embed_dim),
                "proj_in.bias": w(dim), "proj_out.weight": w(ctx, dim), "proj_out.bias": w(ctx),
                "norm_out.weight": torch.ones(ctx).half(), "norm_out.bias": torch.zeros(ctx).half()}
        for i in range(depth):
            a, f = f"layers.{i}.0.", f"layers.{i}.1."
            proj.update({a + "norm1.weight": ones, a + "norm1.bias": zeros,
                         a + "norm2.weight": ones, a + "norm2.bias": zeros,
                         a + "to_q.weight": w(inner, dim), a + "to_kv.weight": w(2 * inner, dim),
                         a + "to_out.weight": w(dim, inner), f + "0.weight": ones,
                         f + "0.bias": zeros, f + "1.weight": w(4 * dim, dim),
                         f + "3.weight": w(dim, 4 * dim)})
    state = {f"image_proj.{k}": v for k, v in proj.items()}
    for i, site in enumerate(attn2_sites(unet.config)):
        inner = unet.get_submodule(site_module(*site)).to_q.weight.shape[0]
        for leaf in ("to_k_ip", "to_v_ip"):
            state[f"ip_adapter.{2 * i + 1}.{leaf}.weight"] = w(inner, ctx)
    return state


def write_image_encoder(path, cfg, seed=0):
    """A synthetic transformers image-encoder directory of ``cfg`` (fp16
    N(0, 0.02) from ``seed``, the port's writer); returns (parameters, GB,
    write s)."""
    import torch

    from pww_tpu_torch.models.clip_vision import CLIPVisionEncoder
    from pww_tpu_torch.weights.bridge import synthetic_state
    from pww_tpu_torch.weights.ip_adapter import save_image_encoder

    t0 = time.perf_counter()
    with torch.device("meta"):
        enc = CLIPVisionEncoder(cfg)
    state = synthetic_state(enc, torch.Generator(device="cuda").manual_seed(seed), torch.float16)
    save_image_encoder(path, cfg, state)
    n = sum(v.numel() for v in state.values())
    return n, os.path.getsize(os.path.join(path, "model.safetensors")) / 1e9, \
        time.perf_counter() - t0


def reference_image():
    """A non-square RGB reference image (the CLIP preprocessing resizes its
    shortest edge and crops)."""
    return synthetic_init_image(320, seed=3)[:256]


def state_snapshot(modules):
    return {name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in modules.items()}


def bit_equal(modules, snapshot):
    """The names of the tensors of ``modules`` that differ from ``snapshot``."""
    import torch

    return [f"{name}.{k}" for name, m in modules.items() for k, v in m.state_dict().items()
            if not torch.equal(v, snapshot[name][k])]


def phase_adapters_reference():
    """Card bf16 against CPU f32: the reduced-depth SD-1.5 (reduced_sd15)
    with a LoRA merged and each IP-Adapter variant attached (a ViT-H image
    tower cut to 2 layers), 256 px, 3 LMS steps; then the ViT-H tower at its
    published size on one reference image, its embeddings and penultimate
    states."""
    import dataclasses

    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPVisionConfig
    from pww_tpu_torch.models.clip_vision import CLIPVisionEncoder, preprocess_clip_image
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.weights.bridge import synthetic_state

    cfg, params, cpu = reduced_sd15()
    gpu = PwwPipeline(cfg, params=params, device="cuda", dtype=torch.bfloat16)
    ref = PwwPipeline(cfg, params=cpu, device="cpu", dtype=torch.float32)
    del params, cpu
    kohya, _ = lora_files({"unet": ref.unet.state_dict(), "clip": ref.clip.state_dict()},
                          {"unet": f"{LORA_UNET_LINEAR}|{LORA_UNET_PROJ}|{LORA_UNET_CONV}",
                           "clip": LORA_TE}, rank=8, alpha=8, seed=11, std=0.1)
    n = [p.load_lora(kohya) for p in (gpu, ref)]
    vcfg = dataclasses.replace(CLIPVisionConfig(), num_layers=2)
    with torch.device("meta"):
        enc = CLIPVisionEncoder(vcfg)
    vstate = synthetic_state(enc, torch.Generator().manual_seed(12), torch.float32)
    image = reference_image()
    kw = dict(prompt="a cat sitting next to a dog", color_map_image=cat_dog_map(256),
              color_context={(255, 0, 0): "cat,0.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=3, seed=0, return_latents=True, ip_adapter_image=image)
    failed = []
    for label, plus in (("standard", None), ("plus", (768, 4, 12, 16))):
        state = ip_adapter_file_state(ref.unet, vcfg.hidden_size if plus else vcfg.projection_dim,
                                      plus=plus, seed=13, std=0.1)
        for p in (gpu, ref):
            p.load_ip_adapter(state, image_encoder=(vcfg, vstate))
        t0 = time.perf_counter()
        got = gpu.generate(**kw)
        t1 = time.perf_counter()
        want = ref.generate(**kw)
        rel = rel_l2(got, want)
        ok = bool(np.isfinite(got).all()) and rel < 5e-2 and n[0] == n[1]
        log(f"[adapters reference] LoRA ({n[0]} modules, rank 8) + IP-Adapter {label}, 256 px, "
            f"3 LMS steps, (320, 640)-channel UNet, ViT-H widths at 2 layers: card bf16 vs CPU "
            f"f32 relative L2 error {rel:.3e} (tol 5e-2), card {t1 - t0:.1f} s, CPU "
            f"{time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    del gpu, ref
    vcfg = CLIPVisionConfig()
    with torch.device("meta"):
        enc = CLIPVisionEncoder(vcfg)
    vstate = synthetic_state(enc, torch.Generator(device="cuda").manual_seed(14), torch.float32)
    card = place(enc, vstate, "cuda", torch.bfloat16)
    with torch.device("meta"):
        enc = CLIPVisionEncoder(vcfg)
    host = place(enc, {k: v.cpu() for k, v in vstate.items()}, "cpu", torch.float32)
    px = preprocess_clip_image(image, vcfg.image_size)
    with torch.inference_mode():
        got = card(px.cuda(), output="hidden_and_pooled")
        t0 = time.perf_counter()
        want = host(px, output="hidden_and_pooled")
        cpu_s = time.perf_counter() - t0
    for label, g, w in zip(("penultimate states", "embeddings"), got, want):
        rel = rel_l2(g.float().cpu(), w)
        ok = bool(torch.isfinite(g).all()) and rel < 5e-2
        log(f"[adapters reference] ViT-H/14 image tower at its published size, {label} "
            f"{tuple(g.shape)}: card bf16 vs CPU f32 ({cpu_s:.1f} s) relative L2 error "
            f"{rel:.3e} (tol 5e-2) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"vision {label}")
    if failed:
        raise SystemExit(f"[adapters reference] card run disagrees with the CPU reference: "
                         f"{failed}")


def place(module, state, device, dtype):
    """A module built on the meta device, given ``state``, for inference."""
    module.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in state.items()},
                           strict=True, assign=True)
    return module.eval().requires_grad_(False)


def timed_run(pipe, call, steps):
    """One call after the launch counters are zeroed: (result, K1-K5
    launches, wall s, peak GiB above what was held before)."""
    import torch

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = call(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, {c.__name__: c.launches for c in counters}, wall,
            (torch.cuda.max_memory_allocated() - held) / 2**30)


def phase_adapters(pipe, kw, steps, card, tmp):
    """LoRA and the IP-Adapter on the main SD-1.5 pipeline at 512², N LMS
    steps, CFG 7.5, the cat/dog map: a kohya LoRA file (rank 64, alpha 32,
    UNet attention, feed-forward, proj and LoCon resnet convs, every text
    linear) written, loaded and run (15/15/10 launches a visit, an image
    unlike the plain one), its peft twin merged bit-equal, the unload
    bit-equal; a ViT-H/14 image encoder directory and the standard and
    plus IP-Adapter files written (fp16) and attached, each run with a
    reference image (15/15/10 a visit; scale 0 bit-equal to the plain image,
    scale 1 unlike it); for the standard one, one request through the
    Batcher and one POST /generate bit-equal to ``generate``, a 4-row
    ``generate_batch`` with one shared image within SERVE_IMAGE_TOL of each
    row alone, and a 5-step profile. Returns ({run: launches}, the IP
    profile, the encoder directory, which stays in ``tmp`` for the SDXL
    phase)."""
    import numpy as np
    import torch

    from pww_tpu_torch.config import CLIPVisionConfig
    from pww_tpu_torch.models.clip_vision import preprocess_clip_image
    from pww_tpu_torch.weights.lora import load_lora_file, merge_lora
    from pww_tpu_torch.weights.safetensors_io import save_file

    gkw = dict(prompt=kw["input_prompt"], color_map_image=kw["color_map_image"],
               color_context=kw["color_context"], guidance_scale=7.5, seed=0, output_type="np")
    problems, launches = [], {}
    image = reference_image()
    plain = pipe.generate(**gkw, num_inference_steps=steps)

    def report(name, out, got, wall, peak, want=None):
        launches[name] = got
        tm = pipe.timings
        log(f"[adapters] {name}: {wall:.3f} s/image, denoise {tm['denoise']:.3f} s "
            f"({tm['denoise'] / steps * 1e3:.1f} ms/step), peak {peak:.2f} GiB above the "
            f"weights, image {out.shape} mean {out.mean():.2f} std {out.std():.2f}, unlike the "
            f"plain image: {not np.array_equal(out, plain)}; launches {got} ({card})")
        if got != (want or path_launches(steps)):
            problems.append(f"{name}: launches {got}")
        if np.array_equal(out, plain) or not out.std() > 0:
            problems.append(f"{name}: its image equals the plain one or is constant")

    # -- LoRA
    towers = {"unet": pipe.unet, "clip": pipe.clip}
    kohya, peft = lora_files({t: m.state_dict() for t, m in towers.items()},
                             {"unet": f"{LORA_UNET_LINEAR}|{LORA_UNET_PROJ}|{LORA_UNET_CONV}",
                              "clip": LORA_TE}, rank=64, alpha=32, seed=21)
    paths = {name: os.path.join(tmp, f"lora_{name}.safetensors") for name in ("kohya", "peft")}
    t0 = time.perf_counter()
    save_file(kohya, paths["kohya"])
    write_s = time.perf_counter() - t0
    save_file(peft, paths["peft"])
    before = state_snapshot(towers)
    merged = {}
    for name, path in paths.items():
        merged[name], n_merged, _ = merge_lora({t: m.state_dict() for t, m in towers.items()},
                                               load_lora_file(path))
    differ = [f"{t}.{k}" for t in merged["kohya"] for k, v in merged["kohya"][t].items()
              if not torch.equal(v, merged["peft"][t][k])]
    del merged
    t0 = time.perf_counter()
    n = pipe.load_lora(paths["kohya"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[adapters] LoRA: kohya file of {len(kohya) // 3} modules (rank 64, alpha 32, fp16), "
        f"{os.path.getsize(paths['kohya']) / 1e6:.1f} MB written in {write_s:.2f} s; load_lora "
        f"{load_s:.3f} s, {n} modules merged; the peft twin's merge differs from the kohya "
        f"merge at {len(differ)} tensors {differ[:4]}")
    if n != len(kohya) // 3 or differ:
        problems.append(f"lora: {n} of {len(kohya) // 3} modules merged, peft differs {differ[:4]}")
    pipe.generate(**gkw, num_inference_steps=2)  # warm-up
    out, got, wall, peak = timed_run(pipe, lambda s: pipe.generate(**gkw, num_inference_steps=s),
                                     steps)
    report("lora", out, got, wall, peak)
    pipe.unload_loras()
    changed = bit_equal(towers, before)
    log(f"[adapters] unload_loras: {len(changed)} UNet and CLIP tensors differ from before")
    if changed:
        problems.append(f"lora unload: {changed[:4]}")
    del before, kohya, peft

    # -- IP-Adapter
    vcfg = CLIPVisionConfig()
    enc_dir = os.path.join(tmp, "image_encoder")
    n_enc, gb, enc_s = write_image_encoder(enc_dir, vcfg, seed=22)
    log(f"[adapters] ViT-H/14 image encoder: {n_enc:.4e} parameters, transformers directory "
        f"of {gb:.3f} GB (fp16) written in {enc_s:.1f} s")
    files = {"ip": ip_adapter_file_state(pipe.unet, vcfg.projection_dim, seed=23),
             "ip_plus": ip_adapter_file_state(pipe.unet, vcfg.hidden_size, seed=24,
                                              plus=(768, 4, 12, 16))}
    profiled = None
    for name, state in files.items():
        path = os.path.join(tmp, f"{name}.safetensors")
        save_file(state, path)
        t0 = time.perf_counter()
        pipe.load_ip_adapter(path, image_encoder=enc_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        enc = pipe._ip["image_encoder"]
        px = preprocess_clip_image(image, vcfg.image_size).cuda()
        with torch.inference_mode():
            enc_ms = time_ms(lambda: enc(px, output="hidden_and_pooled"), reps=5, trials=3)
        log(f"[adapters] {name}: {os.path.getsize(path) / 1e6:.1f} MB file ({len(state)} "
            f"tensors), load_ip_adapter {load_s:.2f} s (the encoder included), "
            f"{pipe.config.unet.ip_adapter_tokens} tokens; image encoder {enc_ms:.3f} ms per "
            f"image ({card})")
        ikw = dict(gkw, ip_adapter_image=image)
        pipe.generate(**ikw, num_inference_steps=2)  # warm-up
        out, got, wall, peak = timed_run(pipe, lambda s: pipe.generate(
            **ikw, num_inference_steps=s), steps)
        report(name, out, got, wall, peak)
        off = pipe.generate(**ikw, num_inference_steps=steps, ip_adapter_scale=0.0)
        log(f"[adapters] {name} at scale 0 equals the plain image: {np.array_equal(off, plain)}")
        if not np.array_equal(off, plain):
            problems.append(f"{name}: scale 0 differs from the plain image")
        if name == "ip":
            problems += serve_ip(pipe, ikw, steps, image)
            profiled = phase_profile(lambda s: pipe.generate(**ikw, num_inference_steps=s),
                                     "adapters ip")
    if problems:
        raise SystemExit(f"[adapters] {problems}")
    return launches, profiled, enc_dir


def serve_ip(pipe, ikw, steps, image):
    """The standard IP-Adapter through the serving path: one request through
    the Batcher and one POST /generate (both run alone through generate),
    each bit-equal to ``generate``'s image; a 4-row ``generate_batch``
    sharing the reference image, each row within SERVE_IMAGE_TOL of the
    request alone. Returns the problems."""
    import base64
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from pww_tpu_torch.serving.batcher import Batcher
    from pww_tpu_torch.serving.server import make_handler, request_from_json

    problems = []
    alone = pipe.generate(**ikw, num_inference_steps=steps)[0]
    req = {k: v for k, v in ikw.items() if k != "output_type"}
    batcher = Batcher(pipe, max_batch=8, max_wait_ms=25.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    body = {"prompt": ikw["prompt"], "seed": ikw["seed"], "steps": steps,
            "guidance_scale": ikw["guidance_scale"],
            "color_context": {str(k): v for k, v in ikw["color_context"].items()},
            "color_map_png_b64": png(ikw["color_map_image"]), "ip_adapter_image_png_b64": png(image)}
    try:
        t0 = time.perf_counter()
        batched = np.asarray(batcher.submit(dict(req, num_inference_steps=steps)).result(600))
        b_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        post = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(post, timeout=600) as r:
            status, out = r.status, json.loads(r.read())
        h_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        batcher.close()
    served = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"]))))
    via_json = pipe.generate(**request_from_json(body), output_type="np")[0]
    ok_b, ok_h = np.array_equal(batched, alone), status == 200 and np.array_equal(served, via_json)
    log(f"[adapters] ip through the Batcher ({b_s:.3f} s) equals generate: {ok_b}; POST "
        f"/generate answered {status} in {h_s:.3f} s with generate's image: {ok_h}")
    if not (ok_b and ok_h):
        problems.append(f"serving: Batcher equal {ok_b}, HTTP {status} equal {ok_h}")
    reqs = serve_requests(steps, n=4)
    t0 = time.perf_counter()
    rows = pipe.generate_batch(reqs, num_inference_steps=steps, output_type="np",
                               ip_adapter_image=image)
    batch_s = time.perf_counter() - t0
    rels = [rel_l2(row, pipe.generate(**dict(r, output_type="np", ip_adapter_image=image))[0])
            for row, r in zip(rows, reqs)]
    log(f"[adapters] ip generate_batch, 4 rows, one reference image: {batch_s:.3f} s "
        f"({batch_s / 4:.4f} s/image), rows against generate alone relative L2 "
        f"{[f'{r:.2e}' for r in rels]} (tol {SERVE_IMAGE_TOL})")
    if max(rels) > SERVE_IMAGE_TOL or len({r.tobytes() for r in rows}) != 4:
        problems.append(f"generate_batch rows {rels}")
    return problems


def phase_sdxl_adapters(pipe, gkw, card, enc_dir, tmp, steps=4):
    """SDXL-base at 1024², ``steps`` LMS steps (cut from N, not the width):
    a kohya LoRA at rank 32 on UNet attention and both text towers
    (``lora_te1_``/``lora_te2_``), 70/70/70 launches a visit and the unload
    bit-equal; an ``ip-adapter_sdxl_vit-h``-shaped file (4 tokens of 2048
    from ViT-H's 1024, 70 sites of 640 and 1280) with the ViT-H encoder,
    70/70/70 a visit, scale 0 bit-equal to no adapter. Returns {run:
    launches}."""
    import numpy as np

    from pww_tpu_torch.weights.safetensors_io import save_file

    want = path_launches(steps, SDXL_LAUNCHES_PER_VISIT["sdxl"], SDXL_NORMS)
    gkw = dict(gkw, output_type="np")
    plain = pipe.generate(**gkw, num_inference_steps=steps)
    towers = {"unet": pipe.unet, "clip": pipe.clip, "clip2": pipe.clip2}
    kohya, _ = lora_files({t: m.state_dict() for t, m in towers.items()},
                          {"unet": LORA_UNET_ATTN, "clip": LORA_TE_ATTN, "clip2": LORA_TE_ATTN},
                          rank=32, alpha=32, seed=31, xl=True)
    path = os.path.join(tmp, "lora_sdxl.safetensors")
    save_file(kohya, path)
    before = state_snapshot(towers)
    t0 = time.perf_counter()
    n = pipe.load_lora(path)
    load_s = time.perf_counter() - t0
    problems, launches = [], {}
    lora, launches["sdxl_lora"], wall, peak = timed_run(
        pipe, lambda s: pipe.generate(**gkw, num_inference_steps=s), steps)
    pipe.unload_loras()
    changed = bit_equal(towers, before)
    del before
    log(f"[sdxl adapters] LoRA: {n} of {len(kohya) // 3} modules (rank 32, lora_te1_ and "
        f"lora_te2_ included), {os.path.getsize(path) / 1e6:.1f} MB, load_lora {load_s:.3f} s; "
        f"{steps} LMS steps 1024²: {wall:.3f} s/image, peak {peak:.2f} GiB above the weights, "
        f"launches {launches['sdxl_lora']}, image unlike the plain one: "
        f"{not np.array_equal(lora, plain)}; after unload_loras {len(changed)} tensors differ "
        f"({card})")
    if n != len(kohya) // 3 or launches["sdxl_lora"] != want or changed:
        problems.append(f"lora: {n} merged, launches {launches['sdxl_lora']}, unload {changed[:4]}")
    state = ip_adapter_file_state(pipe.unet, 1024, seed=32)
    path = os.path.join(tmp, "ip_sdxl.safetensors")
    save_file(state, path)
    t0 = time.perf_counter()
    pipe.load_ip_adapter(path, image_encoder=enc_dir)
    load_s = time.perf_counter() - t0
    ikw = dict(gkw, ip_adapter_image=reference_image())
    out, launches["sdxl_ip"], wall, peak = timed_run(
        pipe, lambda s: pipe.generate(**ikw, num_inference_steps=s), steps)
    off = pipe.generate(**ikw, num_inference_steps=steps, ip_adapter_scale=0.0)
    sites = len(state) // 2 - 2
    log(f"[sdxl adapters] ip-adapter_sdxl_vit-h-shaped file: {sites} sites, "
        f"{os.path.getsize(path) / 1e6:.1f} MB, load_ip_adapter {load_s:.2f} s (the ViT-H "
        f"encoder included); {steps} LMS steps 1024²: {wall:.3f} s/image, peak {peak:.2f} GiB "
        f"above the weights, launches {launches['sdxl_ip']}; unlike the plain image: "
        f"{not np.array_equal(out, plain)}; scale 0 equals it: {np.array_equal(off, plain)} "
        f"({card})")
    if (launches["sdxl_ip"] != want or sites != 70 or not np.array_equal(off, plain)
            or np.array_equal(out, plain)):
        problems.append(f"ip: launches {launches['sdxl_ip']}, {sites} sites, scale 0 equal "
                        f"{np.array_equal(off, plain)}, scale 1 equal {np.array_equal(out, plain)}")
    if problems:
        raise SystemExit(f"[sdxl adapters] {problems}")
    return launches


# K3 at the training path's shapes: SD-1.5 at 512², batch 1 without CFG,
# (L, dh) at B·H 8; five sites of each per UNet call
TRAIN_SHAPES = ((4096, 40), (1024, 80))
TRAIN_STEPS = 3
TRAIN_K3_PER_STEP = 10
# K4 / K5 launches of a train step at the default config: the norm sites
# ahead of the first tensor that requires a gradient take their kernels,
# every later one the f32 composition (the kernels have no backward). TI's
# gradient enters at the first attn2's text keys and values, so down block
# 0's first ResNet (2 K4), its Transformer2D norm (K4) and its first
# block's norm1 and norm2 (2 K5) run ahead of it; LoRA's enters at that
# block's attn1 (norm1 alone of the K5 sites). The set-up encodes each
# image with the VAE under no_grad (SD15_NORMS[2] K4 each).
TRAIN_NORMS_PER_STEP = {"ti": (3, 2), "lora": (3, 1)}
TRAIN_LORA_LR = 5e-3  # 3 Adam steps move each factor by ~1.5e-2, above W's bf16 ulps


def phase_train_kernels():
    """K3 under autograd at TRAIN_SHAPES: the Function (kernel forward, plain
    backward) against autograd through ``self_attention_plain`` on the same
    bf16 inputs, the output and dQ, dK, dV each within 2^-6·max|x| and 1e-2
    relative L2; CUDA-event times. Returns the cases."""
    import torch
    import torch.nn.functional as F

    from pww_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(7)
    cases, failed = [], []
    for l, dh in TRAIN_SHAPES:
        bh = 8
        q, k, v, do = (torch.randn((1, bh, l, dh), generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_self_attention(*leaves)
        through = out.grad_fn is not None and "FlashSelfAttention" in type(out.grad_fn).__name__
        out.backward(do)
        ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref_out = fa.self_attention_plain(*ref)
        ref_out.backward(do)
        label = f"train L{l} dh{dh} B·H{bh}"
        case = dict(case=label, through_function=through)
        # The kernel's output is held as in phase 1 (P rounded to bf16 for
        # P·V). The plain backward and autograd through the plain forward
        # both work in f32 from the same bf16 inputs and round dQ, dK, dV to
        # bf16: they differ by summation order and a bf16 ulp here and
        # there. K3's forward limits (PERF.md error table) hold all four:
        # 2^-6·max|x| and 1e-2 relative L2. A dropped dh^-½ or a transposed
        # dS would miss by 1e-1 and more (estimated, not run).
        pairs = [("o", out.detach(), ref_out.detach())] + [
            (f"d{n}", got.grad, want.grad) for n, got, want in zip("qkv", leaves, ref)]
        for name, got, want in pairs:
            diff = got.float() - want.float()
            err, rel = diff.abs().max().item(), (diff.norm() / want.float().norm()).item()
            tol = 2**-6 * want.float().abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= tol and rel <= 1e-2
            case.update({f"{name}_max_abs_err": err, f"{name}_tol": tol,
                         f"{name}_rel_l2_err": rel})
            if not ok:
                failed.append(f"{label} {name}")
        if not through:
            failed.append(f"{label}: the output has no FlashSelfAttention grad_fn")
        del leaves, ref, out, ref_out
        sq, sk, sv = (x.clone().requires_grad_(True) for x in (q, k, v))
        sout = F.scaled_dot_product_attention(sq, sk, sv)
        case.update(
            ms=time_ms(lambda: fa.flash_self_attention(q, k, v)),
            plain_ms=time_ms(lambda: fa.self_attention_plain(q, k, v), reps=3),
            plain_backward_ms=time_ms(lambda: fa.self_attention_backward_plain(q, k, v, do),
                                      reps=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            library_backward_ms=time_ms(lambda: torch.autograd.grad(
                sout, (sq, sk, sv), do, retain_graph=True)),
            calls_per_train_step=TRAIN_K3_PER_STEP // len(TRAIN_SHAPES))
        # the forward reads q, k, v and writes o; a backward reads q, k, v, dO
        # and writes dQ, dK, dV, and does 2.5 forwards' products (S again,
        # dV, dP, dQ, dK): the bound of a hand-written backward kernel
        case["bound_ms"], case["bound_by"] = bound(4 * q.numel() * 2, 4 * bh * l * l * dh)
        case["backward_bound_ms"], case["backward_bound_by"] = bound(
            7 * q.numel() * 2, 10 * bh * l * l * dh)
        del sq, sk, sv, sout, q, k, v, do
        torch.cuda.empty_cache()
        log(f"[train kernels] K3 {label}: " + ", ".join(
            f"{n} max_abs_err {case[f'{n}_max_abs_err']:.3e} (tol {case[f'{n}_tol']:.3e}) "
            f"rel_l2 {case[f'{n}_rel_l2_err']:.3e}" for n in ("o", "dq", "dk", "dv"))
            + f" {'ok' if label not in ' '.join(failed) else 'FAIL'} | forward kernel "
            f"{case['ms']:.4f} ms (bound {case['bound_ms']:.4f}, {case['bound_by']}), plain "
            f"forward {case['plain_ms']:.4f} ms, SDPA "
            f"forward {case['library_ms']:.4f} ms; plain backward {case['plain_backward_ms']:.4f}"
            f" ms, SDPA backward {case['library_backward_ms']:.4f} ms, a backward's bound "
            f"{case['backward_bound_ms']:.4f} ms ({case['backward_bound_by']})")
        cases.append(case)
    if failed:
        raise SystemExit(f"[train kernels] outside tolerance: {failed}")
    return cases


def train_images(n=2, size=512):
    return [synthetic_init_image(size, seed=40 + i) for i in range(n)]


def refusals_under_grad():
    """K1, K2, K4 and K5 on the card, with an input that requires a gradient
    under grad mode: each must raise NotImplementedError. Returns the ones
    that did not."""
    import torch

    from pww_tpu_torch.ops import cross_attention_kernel as xk
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln
    from pww_tpu_torch.ops.weight_functions import WeightFunction

    def t(*shape, grad=False):
        return torch.randn(shape, device="cuda").to(torch.bfloat16).requires_grad_(grad)

    q, k, v = t(2, 8, 4096, 40, grad=True), t(2, 8, 77, 40), t(2, 8, 77, 40)
    w = torch.rand((2, 4096, 77), device="cuda")
    coef = torch.ones(2, device="cuda")
    calls = {
        "fused_pww_reduce": lambda: xk.fused_pww_reduce(
            q, k, WeightFunction(0.1, "log1p_sigma", "max")),
        "fused_pww_cross_attention": lambda: xk.fused_pww_cross_attention(q, k, v, w, coef),
        "group_norm": lambda: gn.group_norm(t(2, 320, 64, 64, grad=True), torch.ones(
            320, device="cuda"), torch.zeros(320, device="cuda"), groups=32, eps=1e-5),
        "layer_norm": lambda: ln.layer_norm(t(2, 4096, 320, grad=True), torch.ones(
            320, device="cuda"), torch.zeros(320, device="cuda"), eps=1e-5),
    }
    silent = []
    for name, call in calls.items():
        try:
            call()
            silent.append(name)
        except NotImplementedError as e:
            log(f"[train] {name} under grad mode raises: {str(e)[:90]}...")
    return silent


def sites_off_the_kernels():
    """The norm sites on the card where the rule keeps the f32 composition:
    a bf16 input that requires a gradient under grad mode, and an f32 input
    with f32 parameters (an f32 pipeline). Each must launch neither K4 nor
    K5 and give ``group_norm_f32``'s and ``layer_norm_f32``'s result bit for
    bit, under autograd with a ``grad_fn``. Returns the problems."""
    import torch

    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln

    problems = []
    for what, dtype, grad in (("a bf16 input under autograd", torch.bfloat16, True),
                              ("an f32 input", torch.float32, False)):
        g = torch.nn.GroupNorm(32, 320, eps=1e-5, device="cuda", dtype=dtype)
        n = torch.nn.LayerNorm(320, eps=1e-5, device="cuda", dtype=dtype)
        for m in (g, n):
            m.requires_grad_(False)
        gx = torch.randn((2, 320, 64, 64), device="cuda").to(dtype).requires_grad_(grad)
        lx = torch.randn((2, 4096, 320), device="cuda").to(dtype).requires_grad_(grad)
        t = torch.randn((2, 320), device="cuda").to(dtype)
        gn.group_norm.launches = ln.layer_norm.launches = 0
        y = gn.group_norm_site(g, gx, fused=False, silu=True, add=t)
        z = ln.layer_norm_site(n, lx, fused=False)
        launched = (gn.group_norm.launches, ln.layer_norm.launches)
        same = (torch.equal(y, gn.group_norm_f32(g, gn._with_add(gx, t), silu=True))
                and torch.equal(z, ln.layer_norm_f32(n, lx)))
        tracked = not grad or (y.grad_fn is not None and z.grad_fn is not None)
        log(f"[train] norm sites on {what}: K4/K5 launches {launched}, bit-equal to the f32 "
            f"composition {same}, grad_fn kept {tracked}")
        if launched != (0, 0) or not same or not tracked:
            problems.append(f"norm sites on {what}: launches {launched}, same {same}, "
                            f"grad_fn {tracked}")
    return problems


def adam_update(optimizer, p):
    """The step ``torch.optim.Adam`` gave ``p`` last, in f64, from its state
    after that step: lr/(1 - b1^t) · m / (√v / √(1 - b2^t) + eps)."""
    group = next(g for g in optimizer.param_groups if any(x is p for x in g["params"]))
    state = optimizer.state[p]
    t, (b1, b2) = float(state["step"]), group["betas"]
    m, v = state["exp_avg"].double(), state["exp_avg_sq"].double()
    return group["lr"] / (1 - b1**t) * m / (v.sqrt() / math.sqrt(1 - b2**t) + group["eps"])


class LoraStepSpy:
    """Wraps ``LoraTrainer.step`` while ``train_lora`` runs and checks each
    step's A factors against the update Adam gave them. An element moves
    when its update exceeds half the f32 spacing of its value (round to
    nearest; a quarter where it moves down across a power of two); the
    recomputed update differs from the one applied by a few f32 ulps, so the
    gate takes the whole spacing: every element whose update exceeds the
    spacing above |a| must have moved. Where A's gradient is far below 1e-8,
    Adam's step is about lr·g/1e-8 and falls below the spacing: such an
    element may stay, and a whole A may stay at its init."""

    def __init__(self, trainer_cls):
        self.cls, self.step = trainer_cls, trainer_cls.step
        self.init, self.grads, self.ratio, self.due, self.stuck = None, {}, {}, 0, set()

    def __enter__(self):
        import torch

        spy = self

        def step(trainer, factors, optimizer, draws):
            before = {k: f["a"].detach().clone() for k, f in factors.items()}
            if spy.init is None:
                spy.init = before
            out = spy.step(trainer, factors, optimizer, draws)
            for k, f in factors.items():
                a0 = before[k]
                spacing = torch.nextafter(a0.abs(), torch.full_like(a0, math.inf)) - a0.abs()
                ratio = adam_update(optimizer, f["a"]).abs() / spacing.double()
                due = ratio > 1
                spy.due += int(due.sum())
                if bool((due & (f["a"].detach() == a0)).any()):
                    spy.stuck.add(k)
                spy.grads[k], spy.ratio[k] = f["a"].grad.abs().max().item(), ratio.max().item()
            return out

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.step

    def problems(self, factors):
        """After the run: every A has a nonzero, finite gradient at the last
        step (through B and the merge; at step 1, with B = 0, it has none),
        and every element due to move moved at every step. Returns them."""
        import torch

        no_grad = [k for k, g in self.grads.items() if not (g > 0 and math.isfinite(g))]
        still = [k for k, f in factors.items() if torch.equal(f["a"], self.init[k].cpu())]
        log(f"[train] lora: A's gradient at the last step nonzero and finite at "
            f"{len(self.grads) - len(no_grad)} of {len(self.grads)} sites (smallest "
            f"{min(self.grads.values()):.3e}, largest {max(self.grads.values()):.3e}); "
            f"{self.due} elements due to move over the steps, some unmoved at "
            f"{len(self.stuck)} sites; A at its init at {len(still)} sites (largest last "
            f"update there {max((self.ratio[k] for k in still), default=0):.3e} of the f32 "
            f"spacing)")
        return ([f"lora: A without a gradient at {no_grad[:3]}"] if no_grad else []) + (
            [f"lora: A unmoved where Adam's step exceeds its spacing at {sorted(self.stuck)[:3]}"]
            if self.stuck else [])


def phase_train(pipe, kw, steps, card, tmp):
    """Training on phase 5's SD-1.5 pipeline (bf16, 512²): textual inversion
    and LoRA through their entry points, each gated; the trained concept and
    the saved LoRA through ``generate``; ms per step, peak GiB and a profiled
    step of each. Puts the pipeline's tokenizer and token table back as it
    found them. Returns ({run: launches}, {trainer: profile}, the runs'
    results as phase_mesh holds the tp-2 runs against them)."""
    import numpy as np
    import torch

    from pww_tpu_torch.training import train_lora, train_textual_inversion
    from pww_tpu_torch.training.lora import LoraTrainer
    from pww_tpu_torch.training.textual_inversion import TextualInversionTrainer
    from pww_tpu_torch.utils import jax_random
    from pww_tpu_torch.weights.textual_inversion import set_token_table

    problems, launches, profiled = [], {}, {}
    images = train_images()
    caption = "a photo of a pww toy"
    want = {}
    for name, (k4, k5) in TRAIN_NORMS_PER_STEP.items():
        want[name] = {"fused_pww_reduce": 0, "fused_pww_cross_attention": 0,
                      "flash_self_attention": TRAIN_K3_PER_STEP * TRAIN_STEPS,
                      "group_norm": SD15_NORMS[2] * len(images) + k4 * TRAIN_STEPS,
                      "layer_norm": k5 * TRAIN_STEPS}

    # -- textual inversion (the tokenizer and the table are put back at the end)
    emb = pipe.clip.text_model.embeddings.token_embedding
    table0, tokenizer0 = emb.weight.detach().clone(), copy.deepcopy(pipe.tokenizer)
    init_id = pipe.tokenizer("toy")["input_ids"][1]
    ti, launches["train_ti"], wall, peak = timed_run(pipe, lambda n: train_textual_inversion(
        pipe, images, "<pww-toy>", initializer_token="toy", num_steps=n, seed=0), TRAIN_STEPS)
    table = emb.weight.detach()
    old_equal = torch.equal(table[:table0.shape[0]], table0)
    moved = (table[-1].float() - table0[init_id].float()).abs().max().item()
    log(f"[train] textual inversion, {TRAIN_STEPS} steps: {wall:.3f} s (set-up included), "
        f"peak {peak:.2f} GiB above the weights, losses {ti.losses}, table {tuple(table.shape)}, "
        f"old rows bit-equal {old_equal}, new row moved {moved:.3e} from its init; launches "
        f"{launches['train_ti']}, {want['ti']} wanted ({card})")
    if (not np.isfinite(ti.losses).all() or not old_equal or not moved > 0
            or launches["train_ti"] != want["ti"]):
        problems.append(f"ti: losses {ti.losses}, old rows equal {old_equal}, moved {moved}, "
                        f"launches {launches['train_ti']}")

    # -- LoRA
    before = state_snapshot({"unet": pipe.unet})
    with LoraStepSpy(LoraTrainer) as spy:
        lora, launches["train_lora"], wall, peak = timed_run(pipe, lambda n: train_lora(
            pipe, images, caption, rank=8, num_steps=n, learning_rate=TRAIN_LORA_LR, seed=0),
            TRAIN_STEPS)
    zero_b = [k for k, f in lora.factors.items() if not f["b"].any()]
    changed = bit_equal({"unet": pipe.unet}, before)
    log(f"[train] LoRA rank 8, {len(lora.factors)} sites, {TRAIN_STEPS} steps at lr "
        f"{TRAIN_LORA_LR}: {wall:.3f} s (set-up and the A check included), peak {peak:.2f} "
        f"GiB above the weights, losses {lora.losses}; B zero at {len(zero_b)} sites; UNet "
        f"tensors changed {len(changed)}; launches {launches['train_lora']}, {want['lora']} "
        f"wanted ({card})")
    if (not np.isfinite(lora.losses).all() or zero_b or changed
            or launches["train_lora"] != want["lora"] or len(lora.factors) != 128):
        problems.append(f"lora: losses {lora.losses}, {len(lora.factors)} sites, B zero "
                        f"{zero_b[:3]}, UNet changed {changed[:3]}, "
                        f"launches {launches['train_lora']}")
    problems += spy.problems(lora.factors)
    del before, spy
    silent = refusals_under_grad()
    if silent:
        problems.append(f"no refusal under grad mode: {silent}")
    problems += sites_off_the_kernels()

    # -- ms per step and a profiled step of each trainer (their own set-ups)
    trainers = {
        "ti": (TextualInversionTrainer(pipe, images, "<pww-timing>", "toy"),
               lambda tr: tr.init(5e-3)),
        "lora": (LoraTrainer(pipe, images, caption, rank=8),
                 lambda tr: tr.init(0, TRAIN_LORA_LR)),
    }
    for name, (tr, init_fn) in trainers.items():
        state = list(init_fn(tr))
        key = [jax_random.PRNGKey(1)]  # the trainers' stream, as ``fit`` steps it

        def run(n):
            for _ in range(n):
                key[0], k = jax_random.split(key[0])
                _, state[0], state[1] = tr.step(state[0], state[1], tr.draws(k, 1))

        run(1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(TRAIN_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        profiled[name] = phase_profile(run, f"train {name}", steps=1)
        if name == "ti":  # the timing concept's row, so that every token has one
            tr.install(state[0])
        log(f"[train] {name}: {ms:.1f} ms per train step (batch 1, 512², synchronised, "
            f"{TRAIN_STEPS} steps after a warm-up); K3 device ms a call inside a step "
            f"{profiled[name].get('K3 flash_self_attention', (None,))[0]} ({card})")
        del tr, state
    del trainers
    torch.cuda.empty_cache()

    # -- the trained concept and the trained LoRA through generate
    last = {}

    def keep_last(i, t, lat):
        last["lat"] = lat

    gkw = dict(color_map_image=kw["color_map_image"], guidance_scale=7.5, seed=0,
               output_type="np", callback=keep_last, callback_steps=steps)
    runs = {
        "train_ti_generate": dict(gkw, prompt=f"a photo of {ti.placeholder} next to a dog",
                                  color_context={(255, 0, 0): f"{ti.placeholder},0.5",
                                                 (0, 0, 255): "dog,0.5"}),
        "train_lora_plain": dict(gkw, prompt=kw["input_prompt"],
                                 color_context=kw["color_context"]),
    }
    runs["train_lora_generate"] = runs["train_lora_plain"]
    images_out = {}
    for name, rkw in runs.items():
        if name == "train_lora_generate":
            path = os.path.join(tmp, "trained_lora.safetensors")
            lora.save(path)
            n = pipe.load_lora(path)
            if n != len(lora.factors):
                problems.append(f"load_lora merged {n} of {len(lora.factors)}")
        last.clear()
        out, launches[name], wall, peak = timed_run(
            pipe, lambda s: pipe.generate(**rkw, num_inference_steps=s), steps)
        finite = "lat" in last and bool(torch.isfinite(last["lat"]).all())
        images_out[name] = out
        log(f"[train] {name}: {wall:.3f} s/image, image {out.shape} mean {out.mean():.2f} "
            f"std {out.std():.2f}, final latents finite {finite}; launches {launches[name]} "
            f"({card})")
        if launches[name] != path_launches(steps) or not finite or not out.std() > 0:
            problems.append(f"{name}: launches {launches[name]}, finite {finite}")
    differs = not np.array_equal(images_out["train_lora_generate"], images_out["train_lora_plain"])
    pipe.unload_loras()
    log(f"[train] the trained LoRA's image unlike the plain one: {differs}")
    if not differs:
        problems.append("the trained LoRA does not change the image")
    # the later phases see the pipeline that phase 5 built
    pipe.tokenizer = tokenizer0
    set_token_table(pipe, table0)
    if problems:
        raise SystemExit(f"[train] {problems}")
    factors = {k: {n: t.numpy() for n, t in f.items()} for k, f in lora.factors.items()}
    init = {"emb": table0[init_id].float().cpu().numpy()[None],
            "lora": {k: {"a": jax_random.normal(jax_random.fold_in(jax_random.PRNGKey(0), i),
                                                f["a"].shape) / 8.0,
                         "b": np.zeros_like(f["b"])}
                     for i, (k, f) in enumerate(sorted(factors.items()))}}
    return launches, profiled, (ti.losses, ti.embedding.numpy(), lora.losses, factors, init)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30, help="LMS steps of the main path")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only (K1-K5), then their cases as one JSON line and "
                         "each kernel's loss_ms_per_run (A/B of two trees)")
    ap.add_argument("--e2e-reps", type=int, default=0,
                    help="phases 1-2, then the main path's s/image this many times, as many "
                         "turns without and with a ControlNet, and the host time in the "
                         "models' forward and the K2/K3 wrappers (A/B of two trees)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    jax_random_ms = phase_jax_random()
    if args.e2e_reps:
        phase_e2e(args.e2e_reps, args.steps)
        print(f"card: {smi}")
        return 0
    cases = phase_kernels()
    cases.update(phase_norm_kernels())
    if args.kernels_only:
        print(json.dumps(cases))
        print(json.dumps({name: loss_ms_per_run(cs) for name, cs in cases.items()}))
        print(f"card: {smi}")
        return 0
    tcases = phase_train_kernels()
    phase_reference()
    launches, pipe, kw = phase_main_path(args.steps)
    from pww_tpu_torch.pipeline.facade import paint_with_words, paint_with_words_inpaint

    profiled = phase_profile(lambda n: paint_with_words(num_inference_steps=n, **kw), "main")
    for group in ("K1 pww_reduce", "K4 group_norm"):
        if profiled[group][1] != 1:
            raise SystemExit(f"[profile main] {group} is not one device kernel per call")
    phase_img2img(pipe, kw, args.steps)
    phase_utils(pipe, kw, smi)
    tmp = tempfile.mkdtemp(prefix="pww_adapters_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    tlaunches, tprofiled, train_ref = phase_train(pipe, kw, args.steps, smi, tmp)
    mlaunches = phase_mesh(pipe, smi, train_ref)
    blaunches, bprofiled = phase_serve(pipe, args.steps)
    phase_extras_reference()
    elaunches, eprofiled = phase_extras(pipe, kw, args.steps)
    phase_adapters_reference()
    alaunches, aprofiled, enc_dir = phase_adapters(pipe, kw, args.steps, smi, tmp)
    del pipe, kw
    import torch

    torch.cuda.empty_cache()
    phase_graphs(smi)
    flaunches, fprofiled = phase_single_file(args.steps, smi)
    ipipe, ikw = inpaint_pipeline()
    record_norm_sites(ikw)
    phase_inpaint_reference()
    ilaunches = phase_inpaint(ipipe, ikw, args.steps)
    iprofiled = phase_profile(
        lambda n: paint_with_words_inpaint(num_inference_steps=n, **ikw), "inpaint")
    for group in ("K1 pww_reduce", "K4 group_norm"):
        if iprofiled[group][1] != 1:
            raise SystemExit(f"[profile inpaint] {group} is not one device kernel per call")
    del ipipe, ikw
    torch.cuda.empty_cache()
    phase_tiny()
    phase_sd2_reference()
    slaunches, sprofiled = phase_sd21(args.steps, smi)
    torch.cuda.empty_cache()
    phase_controlnet_reference()
    claunches, cprofiled = phase_controlnet(args.steps, smi)
    torch.cuda.empty_cache()
    phase_sdxl_reference()
    phase_sdxl_controlnet_reference()
    xlaunches, xprofiled, ensemble, xalaunches, (xclaunches, xcprofiled) = phase_sdxl(
        args.steps, smi, enc_dir, tmp)
    alaunches.update(xalaunches)
    from pww_tpu_torch.pipeline import facade

    facade._PIPELINE_CACHE.clear()  # the SDXL base and refiner
    torch.cuda.empty_cache()
    phase_sdxl_inpaint_reference()
    xilaunches, xiprofiled = phase_sdxl_inpaint(smi)
    path_kernels = [c.__name__ for c in launch_counters()[:3]]

    kernels = []
    for name, (source, replaces, counter, group, head) in KERNELS.items():
        cs = cases[name]
        top = next(c for c in cs if c["case"] == head)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[counter],
            max_abs_err=max(c["max_abs_err"] for c in cs),
            rel_l2_err=max(c["rel_l2_err"] for c in cs),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"], shape=top["case"],
            loss_ms_per_run=loss_ms_per_run(cs),
            main_path_device_ms_per_call=profiled.get(group, (None,))[0],
            inpaint_path_launches=ilaunches[counter],
            inpaint_path_device_ms_per_call=iprofiled.get(group, (None,))[0],
            sd21_path_launches=slaunches[counter],
            sd21_path_device_ms_per_call=sprofiled.get(group, (None,))[0],
            controlnet_path_launches=claunches[counter],
            controlnet_path_device_ms_per_call=cprofiled.get(group, (None,))[0],
            sdxl_path_launches=xlaunches[counter],
            sdxl_path_device_ms_per_call=xprofiled.get(group, (None,))[0],
            sdxl_controlnet_path_launches=xclaunches[counter],
            sdxl_controlnet_path_device_ms_per_call=xcprofiled.get(group, (None,))[0],
            sdxl_inpaint_path_launches=xilaunches[counter],
            sdxl_inpaint_path_device_ms_per_call=xiprofiled.get(group, (None,))[0],
            single_file_path_launches=flaunches[counter],
            single_file_path_device_ms_per_call=fprofiled.get(group, (None,))[0],
            batch8_path_launches=blaunches[counter],
            batch8_path_device_ms_per_call=bprofiled.get(group, (None,))[0],
            extras_path_launches={run: n[counter] for run, n in elaunches.items()},
            extras_path_device_ms_per_call={
                run: p.get(group, (None,))[0] for run, p in eprofiled.items()},
            adapters_path_launches={run: n[counter] for run, n in alaunches.items()},
            adapters_path_device_ms_per_call=aprofiled.get(group, (None,))[0],
            ensemble_launches=({part: n[path_kernels.index(counter)]
                                for part, n in ensemble.items()}
                               if counter in path_kernels else None),
            train_path_launches={run: n[counter] for run, n in tlaunches.items()},
            mesh_path_launches={run: n[counter] for run, n in mlaunches.items()},
            train_path_device_ms_per_call={
                trainer: p.get(group, (None,))[0] for trainer, p in tprofiled.items()},
            **({"train_cases": tcases} if name == "flash_self_attention" else {}),
            cases=cs,
        ))
    # K4's split form: launched on the spatial inpaint path (phase_mesh, dp 2,
    # rank 0's count: one statistics and one apply launch per GroupNorm site)
    split = cases["group_norm_split"]
    top = split[0]
    kernels.append(dict(
        name="group_norm_split", route="cuda", source="pww_tpu_torch/csrc/group_norm.cu",
        replaces="pww_tpu/ops/group_norm.py:231",
        launches=mlaunches["spatial_inpaint"]["group_norm_stats"],
        apply_launches=mlaunches["spatial_inpaint"]["group_norm_apply"],
        max_abs_err=max(c["max_abs_err"] for c in split),
        rel_l2_err=max(c["rel_l2_err"] for c in split),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=top["library_ms"], shape=top["case"],
        loss_ms_per_run=loss_ms_per_run(split), cases=split))
    log(f"[jax random] host ms per draw: {jax_random_ms}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
