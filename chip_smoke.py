#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (layoutllm_t2i_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py
Phases, in order; each prints JSON lines and any failure exits non-zero:

  1. build     nvcc-builds the five kernel libraries from csrc/ (sm_90a),
               prints build seconds, ptxas lines and the card's name and
               power limit, and fails unless cuobjdump finds wgmma (HGMMA)
               in every K1, K5a, K5b, K4, K6, K7, K8a and K8b kernel (K1
               past d 512: flash_fwd_wide_kernel) and
               in the TF32 wgmma kernels of K1/f32 (widths 40-160; 512;
               past 512 flash_fwd_f32_wide_kernel),
               K5a/f32 and K5b/f32 (widths 40-160; 256 and 320, the
               d-streamed flash_bwd_{dq,dkv}_f32_stream_kernel), K4/f32
               (K6/f32 runs
               K4/f32's), K7/f32 (int8 B tiles converted in shared
               memory), K8a/f32 and K8b/f32 (WGMMA_KERNELS; K4's and
               K7's LN pre-passes and the f32 flash split pre-pass,
               flash_split_f32_kernel, K1/f32's and K5's, do no product),
               or if
               ptxas reports a spill in a K7 kernel or a TF32 wgmma kernel
               (NO_SPILL_KERNELS) or any nvcc log holds C7515 (wgmma
               serialised); prints the registers and spills of every wgmma
               and f32 product kernel and of K2's three kernels
               (GN_KERNELS).
  1a. parallel  parallel/ for generation in ranks of their own, started
               as subprocesses with torchrun's environment once phase build
               has built every kernel (PARALLEL_STEPS: PLMS-10, a depth cut;
               full width, bf16, random weights from seed 0, gates 0.5;
               each rank PARALLEL_CHILD_S s, the group's collectives a
               PARALLEL_GROUP_S s timeout; a non-zero exit or a hung
               collective fails the run): world 1 on NCCL (cuda:0) and
               world 2 on gloo, both ranks on cuda:0 (NCCL refuses two
               ranks on one device; gloo takes the CUDA tensors as they are):
               generate_sharded on REQUESTS (batch 2) and generate_tp
               ('heads', 'spatial') on the first request, each against
               generate on the same requests at PSNR >= 35 dB
               (tests/parity_setup.py's gate); walls per rank, labelled
               world-1 or shared-card (not TP speed-ups); each run's
               launches counted apart, and each must launch K1, K2, K3 and
               K4 ('heads' at world 2: K6 on a rank's inner slice for K4);
               world 1 also runs the port bench with --sharded in-process
               (batch 2, 1 iteration, PLMS-10). World 2 must launch K1 at
               the local shapes (q 2048 rows against K/V 4096 at d 40,
               'spatial' at 64^2; 4 heads, 'heads') and K2's split pair
               (partials all-gathered between its launches), and 'heads'
               K6 at a rank's inner slice; their shapes join phase
               kernels' second pass (K2's split rows: rank 0's
               block, every rank's partials, against the plain GroupNorm of
               all the rows; no library call). Then cli/serve.py --tp at
               world 2 on the card (gloo, cuda:0): two POSTs each answered
               with a 512x512 PNG, /metrics counting both, both ranks
               exiting 0 after rank 0's SIGINT.
  1b. train-dp parallel/ for training, in ranks of their own as in 1a (the
               same limits): the DiffusionTrainer at full width in f32,
               rela_fuse, AdamW, synthetic 512^2 data, random weights from
               seed 0 with gates 0.5, global batch TRAIN_BATCH,
               TRAIN_DP_STEPS steps. World 1 on NCCL; world 2 on gloo with
               both ranks on cuda:0 (4 rows a rank), once plain and once
               with ZeRO-1 (cuDNN's deterministic algorithms, so that both
               runs get the same gradients). World 2's first all-reduced
               gradient within TRAIN_GRAD_F32_REL_TOL of world 1's
               (relative L2), each logged loss within
               TRAIN_DP_LOSS_REL_TOL, the 3-step update of the trained
               tensors within TRAIN_DP_UPDATE_REL_TOL of world 1's
               (relative L2), every trained tensor within 2 lr a step (a
               sanity bound: AdamW moves an element by about lr a step at
               most, so no update can leave it); ZeRO-1 bit-equal to plain on both ranks, its moments
               a rank each leaf's zero1_dim share; each rank's K1, K5a,
               K5b and K4 (f32) launches the walk's at its local batch
               (training_calls), K2 and K3 launched; the calls' shapes
               join phase kernels' second pass. Prints each rank's moment
               bytes, peak memory and walls (world-1 or shared-card, not
               DP speed-ups). Then cli/train_diffusion.py --synthetic
               --zero1 --multihost --backend gloo at world 2 for
               TRAIN_DP_CLI_STEPS steps: both ranks exit 0, one run
               directory (tag00) holds the checkpoint.
  2. kernels   every kernel (K1 flash attention, K2 GroupNorm, K3 LayerNorm,
               K4 LN+GEGLU FF, K5a/K5b flash-attention backward, K6 GEGLU
               FF + residual, K7 int8 LN+GEGLU FF, K8a GEMM + bias, K8b
               GEGLU GEMM) against its plain PyTorch version on the card,
               in bf16 (K7 on int8 weights) and, for every kernel (K1 with
               and without its lse), in f32: rows labelled "f32" and
               kernel "K1/f32" etc., held to the f32 rows of
               kernels/tolerance.py, with `arith` (3xTF32 wgmma for K1,
               K5a, K5b, K4, K6, K8a and K8b; K7 two TF32 products
               against its int8 weights; f32 without products for K2 and
               K3), bound at 4-byte elements (K7's
               weights 1, its scales 4) and the TF32 peak (495 TFLOP/s;
               K2, K3: the f32 peak), library calls in f32 with
               allow_tf32 off; at every distinct shape that phases 4-11,
               11b, 13 (its preview too), 13b, 15, 16, 17 and 18 give it
               (mixed-precision training's
               VAE and CLIP run in f32); times
               kernel, plain version and
               one PyTorch library call for the same function, beside the
               roofline bound. `ms`, `plain_ms` and `library_ms` are
               launched back to back from the host (time_ms; runs of
               ~30 ms, at most 100 calls), so a call
               shorter than its launch path reads the host's time;
               `device_ms` and `library_device_ms` take the host out
               (device_time), and `host_us` is the kernel wrapper's host
               time a call. K1's, K5a's and K5b's rows add `exp_ms`, the
               time of their exponentials at the SFUs' rate (exp_ms()); the
               rows of the kernels on wgmma (K1, K5a, K5b, K4, K6, K7, K8a,
               K8b) and K2's add `vs_library`, ms over library_ms, and
               `device_vs_library`; K2's add the path its plan takes
               (`path`: "cluster" on chip or "stream"), `cluster` (blocks a
               cluster) and `slab` (channels). Before the rows: the
               wrappers' raw stream handle against
               torch.cuda.current_stream().cuda_stream outside and inside a side stream (a mismatch fails), and the
               host floor of a call, torch.empty_like plus an empty C entry
               point with K3's eight arguments through ctypes (host_floor).
               K5a's and K5b's library call is SDPA's whole backward (dQ,
               dK and dV), so after both rows of a shape a "K5 pair" row
               holds their sum against that call, counted once, with the
               bound and exp_ms of that function (pair_work()), not the
               sum of the two rows' (both kernels recompute S and dP).
  3. unet      one full-width UNet forward through the kernels and again
               through the plain versions (fuser and relation alphas set to
               0.5 first: random init leaves them 0, which would hide a
               fuser fault behind tanh(0) = 0).
  4. generate  random_models() at full SD-1.4 width in bf16, then PLMS-50,
               CFG 7.5, alpha (0.3, 0, 0.7), vae_chunk 8 on 2 requests;
               checks shape, finiteness and range; counts kernel launches.
  5. fast      the fast preset (pipeline/presets.py, as `cli/serve.py
               --fast` expands it: DPM-Solver++ 15 steps, CFG only on the
               steps in (0, 0.75), the UNet encoder re-run every 2nd step)
               on phase 4's bundle, requests, seed and alpha: wall s, img/s,
               peak memory, UNet evaluations (CFG at batch 4 / cond-only at
               batch 2, key / propagated) against the step tables, launches,
               and `psnr_vs_exact_db`, the worse image's PSNR against phase
               4's from the same noise, which must be >= 30 dB.
  6. serve     GenerationServer on 127.0.0.1 with phase 5's pipeline at
               batch 2: /healthz after the warm-up, three concurrent POSTs
               (one full batch, one padded); every reply a 512x512 RGB PNG
               (decoded with zlib), /metrics 3 requests, 2 batches, 1
               padded row, 0 errors; the padded request byte-identical to
               pipe.generate on its padded batch; the batched requests
               against themselves alone (per-request seeds): max |d| and
               PSNR >= 35 dB.
  7. int8      quantize_unet_int8 of phase 4's bundle: the UNet's dense and
               int8 bytes; under LLT2I_FFN_INT8=1 a UNet forward through
               K7 against the plain route and against the default int8
               route (dequantize, then cuBLAS); then phase 4's generation,
               its launches and its mean |int8 - dense| image difference.
  8. routes    under LLT2I_FFN_LN=0 and LLT2I_PALLAS_MATMUL=1 (K3 + K6 at
               the norm3 sites, K3 + K8b + K8a at the fusers' dense
               branch): a UNet forward against the plain route, then phase
               4's generation and its launches.
  8a. inpaint inpainting on phase 4's bundle: z0 a VAE posterior sample
               of phase 4's first image, REQUESTS' boxes the region to
               paint (cli/gligen_inference.py inpaint_conditioning), the
               blend's noise drawn once and fed to both routes; exact
               PLMS-50 and the fast preset (its encoder cache off under
               inpainting), each through the kernels and again under
               plain_route(): PSNR >= 35 dB, the fast run's UNet
               evaluations the uncached step tables' (utils/flops.py
               unet_evaluations(..., inpaint=True)), the exact run's final
               latent within INPAINT_KEPT_TOL of z0 (mean |d|) over the
               kept region while the painted region, a planted inverted
               mask, exceeds it; then an inpaint_mode UNet (PLMS-10; 9 input
               channels: the latent, z0 * mask, the mask) on one exact
               generation, both routes.
  8b. modalities  random_models(seed 0) at full width in bf16, adapted by
               adapt_models_for_modality, gated alphas 0.5, alpha
               (1, 0, 0), each at PLMS-10 (a depth cut): canny
               (ConvNeXt-tiny at 448^2 in f32, the downsampler's 8
               channels) and, at PLMS-10 (a depth
               cut), keypoint (2 persons), text_image (the ViT-L/14 vision
               tower in f32 on one reference PNG, a 2-box layout), a
               gatedSA2 UNet on canny, a gatedCA UNet on canny and on
               keypoint: each run's images through the kernels against
               plain_route()'s (PSNR >= 35 dB), K1-K4 launched, and the
               gatedCA runs' K1 at M = 196 and M = 136.
  8c. hires    the seed-0 weights at SD-1.4's 768^2 (UNetConfig(image_size=
               96): 96^2 latents; GEOMETRY), REQUESTS at CFG 7.5: PLMS-10
               (a depth cut) in bf16 and on the f32 bundle, each
               through the kernels and again under
               plain_route() from the same noise: PSNR >= 35 dB, K1-K4 (or
               their f32 forms) launched, K1's launches the walk's in all
               and site by site at d 160 (N 576, M 576; the gated 606) and
               at the VAE's d 512 (N 9216).
  8d. heads5   the same weights with num_heads 5 at 512^2, PLMS-10 in bf16
               and in f32: the same gates, K1's launches at d 64 and 128
               the walk's site by site.
  8e. heads1   the same weights with num_heads 1 at 512^2, PLMS-10 in bf16
               and in f32: the same gates, K1's launches at d 320 (N 4096,
               4126) and d 640 (the column-group kernels past 512; N 1024,
               1054) the walk's site by site.
  8f. hires1   num_heads 1 at 768^2, PLMS-10 in bf16 and in f32: the same
               gates at d 320 (N 9216, 9246), 512 (the VAE's, N 9216), 640
               (N 2304, 2334) and 1280 (N 576, 606). Neither trains: K5
               past d 320 is not ported (ROADMAP.md Queue 2).
  9. bench     the port bench (cli/bench.py) as run with no flags, in this
               process: random weights from seed 0, bf16, 8 requests (CFG
               batch 16), iters 3, exact PLMS-50 then the fast preset on the
               same noise; prints the bench's JSON line, then fails on its
               fast_error, on fast_psnr_vs_exact_db < 30 dB, on an image not
               finite or outside [0, 1], on an mfu outside (0, 1], or on a
               flops_per_image other than utils/flops.py's count.
 10. cli       the generation CLIs at full width on the card, one request
               each: cli/txt2img.py main with --layout and again through
               the offline planner (a candidate JSON, a layout-cache JSON
               and a random policy .pt written to build/), cli/
               gligen_inference.py main with --negative_prompt, with
               --inpaint_image (phase 4's first image as a 512^2 PNG),
               --modality canny --map_path, --modality keypoint
               --keypoints and --modality text_image --image_refs, and two
               POSTs to cli/demo.py's /api/generate on 127.0.0.1, one with
               a PNG data URL to inpaint; every PNG decodes (zlib) to
               512x512 RGB, with its layout's box outlines in blue where
               it has a layout. Then phase kernels' second pass: the
               shapes that phases 1a, 1b, 8a, 8b and 10 recorded as they
               ran (recorded_calls) and the first pass did not hold.
 11. rl        the RL path at full width on a fixture written to build/
               (4 COCO-style examples, 512^2 PNGs, a layout cache): the
               reward (CLIP ViT-L/14 text and vision towers and the
               aesthetic MLP in f32, random weights from seed 0) on 4
               rollouts of the exact pipeline, each component's max |d|
               between the kernel route and plain_route() within
               RL_REWARD_TOL; then cli/train_rl.py main, 2 epochs of one
               batch of 4 PLMS-50 rollouts, and 1 more epoch resumed from
               its directory: finite rewards and losses, the policy
               changed each epoch, ckpt_E.pt, state_E.pt and history.json
               loaded back, Adam's step count 1, 2, 3; seconds an epoch,
               rollout and reward seconds, peak memory, K3 f32 launches.
 11b. eval     eval/nss1k.py main in-process at full width on a fixture
               written to build/ (the five NSS1K split files, 2 examples
               each in the reference schema, 512^2 ground-truth PNGs, a
               planner candidate pool and layout cache, a random-init
               InceptionV3 saved under torchvision's names): run A, the
               five splits under --fast at batch 2 (five rows of n 2, an
               overall row of n 10, every clip_score_mean finite and in
               [0, 2.5]); run B, one split at exact PLMS-50 with --layout
               planner and --fid (layout_miou and layout_docsim in [0, 1],
               both layouts parsed, fid finite); the Inception's features
               of 2 images on the card against the CPU, both f32 with TF32
               off (relative L2 <= EVAL_INCEPTION_REL_TOL), and its ms per
               image at batch 16; each run's sec_per_image; K1-K4 and K3's
               f32 form launched in each run.
 12. train-grad  one full-width loss backward at batch 2 (f32 master
               weights, bf16 compute, alphas 0.5), kernel route against
               plain route: the relative L2 error of the rela_fuse
               gradients against a stated bound, which a planted fault of
               the K5 backward must exceed; every kernel of the step
               launched, none on the plain route.
 13. train     DiffusionTrainer at full width on synthetic 512^2 data: batch
               8, rela_fuse, AdamW, mixed precision (the UNet in bf16; the
               VAE and CLIP encode in f32, as the JAX trainer's), warmup 0,
               alphas 0.5; 2 warm-up steps then 5 timed ones; s/step,
               images/s, peak memory, finite losses, every rela_fuse tensor
               changed and every frozen one bit-identical; kernel launches
               per step, K1's and K5's (bf16 and f32, the VAE's d 512
               site) exactly the walk's (training_calls) count a step.
               Then one preview (train-preview): sample_previews on the
               next batch at PREVIEW_STEPS (PLMS-10, a depth cut of the
               reference's 50; CFG batch 16, bf16): both PNGs decode to
               grids of 512^2 tiles, every rela_fuse tensor bit-identical
               before and after, its wall s, K1-K4 and K3/f32 launched.
 13a. data     host only, after phase 13's preview: a fixture written from
               numpy seed 0 with utils/images.py (a TSV of base64 PNGs at
               non-square sizes with entity boxes and embeddings, a
               condition-map pair of directories, COCO person keypoints);
               VGGrounding, DIODENormal and COCOKeypoint built by name
               through build_datasets at 512^2, joined by
               ConcatDataset(repeats=[2, 1, 1]) and drawn through
               PrefetchLoader for 2 epochs: each epoch a permutation of the
               concatenation, items equal to direct reads; shapes, dtypes,
               ranges (images in [-1, 1], maps in [0, 1], boxes and
               keypoints in [0, 1] where masked); the TSV's .lineidx and
               tsv_split/tsv_merge round trip byte for byte.
 13b. train-coco  cli/train_diffusion.py main --coco_root on a COCO-2014
               fixture (16 captioned PNGs of assorted sizes, one caption
               each with a relation phrase, a crowd box, a box the crop
               makes degenerate, one image without a caption),
               --mixed_precision, batch 8, 3 steps (crossing the epoch) at
               full width: finite losses; K1-K5b and the encoders' K1/f32,
               K2/f32, K3/f32 launched; K1's, K1/f32's, K5a's and K5b's
               launches the walk's (training_calls) over the loader's
               batches rebuilt on the host (coco_walk); the first batch
               (8, 512, 512, 3), the crowd, degenerate and captionless
               entries absent; s/step, images/s, peak memory, the loader's
               and one thread's decode s a batch. Then phase kernels' third
               pass: the walk's shapes that the passes before did not hold
               (the grounding texts' encoder batches).
 13c. train-hires  cli/train_diffusion.py main --synthetic --image_size
               768 at batch 8, 2 steps, --mixed_precision and again in f32
               (the UNet at 96^2 latents): finite losses, K1's, K5a's and
               K5b's launches (bf16 and f32) the walk's a step; then phase
               12's check at 96^2 latents, with num_heads 5, with
               num_heads 2, with num_heads 5 at 96^2 latents, with
               num_heads 1 and with num_heads 1 at 96^2 latents, bf16 and
               f32 (train-grad-hires[-f32], train-grad-heads5[-f32],
               train-grad-heads2[-f32], train-grad-hires5[-f32],
               train-grad-heads1[-f32], train-grad-hires1[-f32]): the
               planted dK fault must exceed the bound, K5's launches at
               d 40/80/160, 64/128, 160/320, 64/128/256, 320/640 or
               320/640/1280 the walk's site by site (past 320 K5's
               column-group kernels). Then train-ckpt-heads2 and
               train-ckpt-heads1: the seed-0 weights written by the port's
               .pth writer with a GLIGEN config_dict of num_heads 2, then
               1 (build/chip_smoke_train, 5.5 GiB, removed after), trained
               by cli/train_diffusion.py main --synthetic
               --mixed_precision --ckpt_path at batch 8, 2 steps: finite
               losses, K1's and K5's launches the walk's, K5's sites at d
               160 and 320 (320 and 640) the walk's; s/step, peak
               memory.
 14. train-grad-f32  phase 12 with mixed_precision=False: every operand
               f32, the kernels' f32 forms, bound TRAIN_GRAD_F32_REL_TOL.
 15. train-f32 phase 13 with TrainerConfig()'s precision, f32 throughout
               (the JAX package's default): the same checks, the f32 forms
               of K1-K5b launched (K1 at d 40, 80 and 512).
 16. generate-f32  random_models(dtype=torch.float32) at full width, phase
               4's generation (requests, seed, alpha, PLMS-50, CFG 7.5)
               through the f32 forms of K1-K4: shape, finiteness, range,
               wall s, peak memory; every launch the walk's count
               (generation_walk: every UNet evaluation of the step tables);
               each image's PSNR against phase 4's bf16 image from the
               same noise, printed, not bounded.
 17. int8-f32  phase 7 on quantize_unet_int8 of phase 16's f32 bundle
               (int8 values, f32 scales, the rest f32) under
               LLT2I_FFN_INT8=1: K7/f32 in a UNet forward against the
               plain and the default int8 route, then phase 16's
               generation: mean |int8 - dense f32| image difference within
               INT8_IMAGE_TOL, K7/f32's launches the walk's.
 18. routes-f32  the split FF routes (LLT2I_FFN_LN=0, LLT2I_PALLAS_MATMUL=1)
               in f32: a full-width UNet forward (alphas 0.5) against the
               plain route (K6/f32, K8a/f32, K8b/f32, no K4/f32); phase 14
               under the route (routes-f32-grad: no planted faults,
               TRAIN_GRAD_F32_REL_TOL, the route's kernels launched, none
               on the plain route); phase 15 under the route at 1 warm-up
               and 2 timed steps (routes-f32-train: s/step, peak memory,
               finite losses, K1, K5a, K5b, K6, K8a and K8b a step the
               walk's count).
 19. the `kernels` JSON line, then the card line, then the result line.
     In that line `ms`, `plain_ms`, `library_ms`, `bound_ms`, `device_ms`
     and `library_device_ms` are sums
     over the kernel's distinct main-path shapes (one call at each, as
     timed in phase 2), and the wgmma kernels' `vs_library` and
     `device_vs_library` are the ratios of those sums; `launches` adds
     the runs of phases 1a (every rank's), 4, 5, 7-8f, 9-11, 11b (its two
     runs), 13 (its steps and its preview), 13b, 13c (its CLI runs and its
     kernel-route backwards), 15, 16, 17 and 18 (its training), each
     read from counts set to 0 just before it (K2's entry
     adds `split`: its split rows' sums and the split pair's launches);
     each f32 form
     has an entry of its own ("K1/f32 flash_attention", ...), its rows'
     sums, its f32 launches and its `arith`, and the bf16 entries count
     bf16 launches only. K1's and K5's entries add `by_width`: their
     rows' sums by the width of the instantiation each head dim runs on
     (kernels/flash_attention.py kernel_width). K5a's and K5b's
     entries carry the pair's sums (`pair`: ms, device_ms, library_ms and
     library_device_ms of SDPA's backward counted once, bound_ms, exp_ms,
     vs_library, device_vs_library, and the largest shape's vs_library).
     `host_us_median` is the median of the kernel's `host_us` over its
     shapes. K2's entry adds `unet_eval_device_ms`: phase 2's device_ms
     summed over the 61 K2 calls of one CFG-batch-4 UNet evaluation
     (unet_calls), each shape weighted by its calls.

Phase 2's shapes are walked from the model configs (generation_calls,
training_calls), and the head dims that no model here routes to them
(HEAD_DIM_CALLS: bf16 48, 72, 504 and 636; d 20, 96, 144, 168, 256, 300,
328, 520, 640 and 1280 in both types; each lse site is also a K5a and a
K5b case), the K1 sites with their lse past d 160 of phase train-hires'
gradient checks (num_heads 5 at 768^2 and num_heads 2 at 512^2: K5 at d
256 and 320) and past d 320 (num_heads 1 at 512^2 and 768^2: K5 at d 640
and 1280), batch 2, both types (wide_k5_sites), the
generation and a batch-8 training step at 768^2 and with num_heads 5
(phases hires, heads5 and train-hires), the generation with num_heads 1
at 512^2 and 768^2 (phases heads1 and hires1: K1 at d 320, 640 and 1280),
bf16 and f32, and train-ckpt's
batch-8 mixed-precision steps at num_heads 2 and 1; the
generation at
2 requests (CFG batch 4) on each of
its three routes (Route: the default, int8, and the split FF routes), the
fast preset's evaluations from its step tables (unet_evaluations: CFG at
batch 4, cond-only at batch 2, with and without the gated fusers, key
and propagated), the bench's 8 requests (exact: CFG batch 16; fast: CFG
16 and cond-only 8), the CLIs' one request (CFG batch 2) and the
planner's CLIP features (cli_paths), the RL batch's 4 rollouts (CFG
batch 8) and the reward's f32 towers (rl_calls), the NSS1K runs' fast
and exact generations at batch 2 with the reward's towers on 2 images and
the planner's features (eval_paths), the training preview at CFG batch
16 (preview_calls), the f32 bundle's
generation on the default and the int8 route ("generate-f32",
"int8-f32"), and a training step at batch 8 with no CFG doubling: the VAE
encoder on 512^2 images (K1 at d 512), CLIP on the captions and on the
grounding texts, all in f32, and the UNet in bf16 ("train"), in f32
("train-f32") and in f32 on the split routes ("routes-f32"), whose flash
sites after the first relation fuser run K1 with its lse (N = M =
4096/4126 at d 40, 1024/1054 at d 80). Each of
those is also a K5a and a K5b case, on the lse and delta of the plain
forward. The walk routes each feed-forward site as ops/nn.py does, with
the same eligibility tests (ff_site_calls). tests/test_torch_smoke_shapes.py
holds the walk against the calls that a small model makes on the CPU.

With `--profile OUT.json`, one more generation runs under torch.profiler
after phase 4 and prints device time by kernel group (each group's kernels'
summed times) and the device's busy time, the union of the trace's kernel,
copy and set intervals, so that activities that overlap count once, with
its idle share of the wall; OUT.json gets the per-kernel table. One more generation is profiled
likewise after phases 5, 7 and 8 (OUT_fast.json, OUT_int8.json,
OUT_routes.json), one more exact generation of the bench's 8 requests
after phase 9 (OUT_bench.json), and one more training step after phases
13 and 15 (OUT_train.json, OUT_train-f32.json), one more f32 generation
after phase 16 and one more on phase 17's route (OUT_f32.json,
OUT_int8-f32.json), and one more training step of phase 18
(OUT_routes-f32.json).

The script imports nothing of JAX or of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import dataclasses
import functools
import importlib
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak, H100 SXM
H100_TF32_FLOPS = 495e12    # dense TF32 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12    # HBM3 bytes/s, H100 SXM
H100_SMS = 132              # streaming multiprocessors, H100 SXM
MUFU_PER_SM_CLOCK = 16      # ex2 results a clock per SM (the SFUs)

# kernel vs plain version: the tolerances stated in
# layoutllm_t2i_torch/kernels/tolerance.py (element-wise atol + rtol*|b|,
# K1's atol a fraction of the output's rms, and a whole-tensor rms bound)
# full-width UNet forward, kernel route vs plain route: max |a-b| / max |b|
UNET_REL_TOL = 5e-2
# full-width loss backward at batch 2, kernel route against plain route:
# ||g_k - g_p|| / ||g_p|| over all rela_fuse gradients. Both round to bf16
# at the same points and differ by summation order through 16 transformer
# blocks forward and back. On the H100 that reads 4.4e-3, and the planted
# K5 fault of TRAIN_GRAD_CAUGHT 4.4e-2 (planted_fault): the bound sits
# between. Those of TRAIN_GRAD_UNSEEN read within 3 % of the kernel route,
# lost in the rounding of the bf16 backward; they are run and reported,
# not bounded: phase 2 and tests/test_torch_kernels.py hold K5 against
# such faults.
TRAIN_GRAD_REL_TOL = 1e-2
# the same in f32 (phase train-grad-f32): both routes f32, the kernels'
# products 3xTF32, so they differ by summation order and a few ulps
# through the same blocks; the bound is 1e-3, and the planted dK fault
# (dK off by the factor 1 / scale) lies far above it
TRAIN_GRAD_F32_REL_TOL = 1e-3
TRAIN_GRAD_CAUGHT = ("dk_unscaled",)
TRAIN_GRAD_UNSEEN = ("softmax_scale", "dq_1pct", "dq_kv_tail")

# library -> its kernels written on csrc/hopper.cuh's wgmma: K1, K5a, K5b;
# K4's, K6's and K7's up and down GEMMs, K8a and K8b on csrc/gemm_tiles.cuh;
# the f32 forms' TF32 wgmma kernels, K1/f32 at widths up to 160 (S with Q and K
# by descriptor, P V with P as register A), at d 512 and past it (the
# column groups, in bf16 too), K5a/f32 and
# K5b/f32 (the scores by descriptor, P and dS as register A; past d 160
# the d-streamed kernel, past 320 its column groups, in bf16 too), K4/f32's
# (and
# K6/f32's) and K7/f32's up and down GEMMs, K8a/f32 and K8b/f32
# (csrc/tf32_gemm.cuh; K7/f32's with int8 B operands, Cfg::kQ).
# Each must show HGMMA in its SASS, in every instantiation.
WGMMA_KERNELS = {
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_wide_kernel",
                        "flash_bwd_dq_kernel",
                        "flash_bwd_dkv_kernel", "flash_bwd_dq_wide_kernel",
                        "flash_bwd_dkv_wide_kernel", "flash_fwd_f32_ss_kernel",
                        "flash_fwd_f32_wgmma_kernel",
                        "flash_fwd_f32_wide_kernel",
                        "flash_bwd_dq_f32_ss_kernel",
                        "flash_bwd_dkv_f32_ss_kernel",
                        "flash_bwd_dq_f32_stream_kernel",
                        "flash_bwd_dkv_f32_stream_kernel",
                        "flash_bwd_dq_f32_wide_kernel",
                        "flash_bwd_dkv_f32_wide_kernel"),
    "ffn": ("ffn_up_wgmma_kernel", "ffn_down_wgmma_kernel",
            "ffn_res_up_wgmma_kernel", "ffn_res_down_wgmma_kernel",
            "ffn_q_up_wgmma_kernel", "ffn_q_down_wgmma_kernel",
            "ffn_up_f32_wgmma_kernel", "ffn_down_f32_wgmma_kernel",
            "ffn_q_up_f32_wgmma_kernel", "ffn_q_down_f32_wgmma_kernel"),
    "matmul": ("linear_wgmma_kernel", "geglu_wgmma_kernel",
               "linear_f32_wgmma_kernel", "geglu_f32_wgmma_kernel"),
}
# the kernels whose rows are held against their library call (vs_library)
WGMMA_KIDS = ("K1", "K5a", "K5b", "K4", "K6", "K7", "K8a", "K8b")
# K2's kernels: the on-chip path's cluster kernel, the streaming path's two;
# phase build prints their registers and spills
GN_KERNELS = ("gn_cluster_kernel", "gn_stats_kernel", "gn_apply_kernel")
VS_LIBRARY_KIDS = WGMMA_KIDS + ("K2",)
# K7's kernels and the TF32 wgmma kernels, which must compile without a
# spill (ptxas)
NO_SPILL_KERNELS = ("ffn_q_up_wgmma_kernel", "ffn_q_down_wgmma_kernel",
                    "flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
                    "flash_bwd_dkv_wide_kernel",
                    "flash_fwd_f32_ss_kernel", "flash_fwd_f32_wgmma_kernel",
                    "flash_fwd_f32_wide_kernel",
                    "flash_bwd_dq_f32_ss_kernel", "flash_bwd_dkv_f32_ss_kernel",
                    "flash_bwd_dq_f32_stream_kernel",
                    "flash_bwd_dkv_f32_stream_kernel",
                    "flash_bwd_dq_f32_wide_kernel",
                    "flash_bwd_dkv_f32_wide_kernel",
                    "linear_f32_wgmma_kernel", "geglu_f32_wgmma_kernel",
                    "ffn_up_f32_wgmma_kernel", "ffn_down_f32_wgmma_kernel",
                    "ffn_q_up_f32_wgmma_kernel", "ffn_q_down_f32_wgmma_kernel")

KERNEL_META = {
    "K1": ("flash_attention", "layoutllm_t2i_torch/csrc/flash_attention.cu",
           "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:349"),
    "K2": ("group_norm", "layoutllm_t2i_torch/csrc/group_norm.cu",
           "layoutllm_t2i_tpu/ops/pallas/norms.py:120"),
    "K3": ("layer_norm", "layoutllm_t2i_torch/csrc/layer_norm.cu",
           "layoutllm_t2i_tpu/ops/pallas/norms.py:333"),
    "K4": ("ffn_ln_geglu", "layoutllm_t2i_torch/csrc/ffn.cu",
           "layoutllm_t2i_tpu/ops/pallas/ffn.py:182"),
    "K5a": ("flash_attention_bwd_dq", "layoutllm_t2i_torch/csrc/flash_attention.cu",
            "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:533"),
    "K5b": ("flash_attention_bwd_dkv", "layoutllm_t2i_torch/csrc/flash_attention.cu",
            "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:555"),
    "K6": ("ffn_geglu", "layoutllm_t2i_torch/csrc/ffn.cu",
           "layoutllm_t2i_tpu/ops/pallas/ffn.py:140"),
    "K7": ("ffn_ln_geglu_q", "layoutllm_t2i_torch/csrc/ffn.cu",
           "layoutllm_t2i_tpu/ops/pallas/ffn.py:383"),
    "K8a": ("linear_fused", "layoutllm_t2i_torch/csrc/matmul.cu",
            "layoutllm_t2i_tpu/ops/pallas/matmul.py:131"),
    "K8b": ("geglu_fused", "layoutllm_t2i_torch/csrc/matmul.cu",
            "layoutllm_t2i_tpu/ops/pallas/matmul.py:169"),
}
# every kernel's f32 form, an entry of its own: the same Pallas kernel
# (which takes any float type) and source, f32 instantiations (K1, K5a,
# K5b, K4, K6, K8a and K8b: 3xTF32 on wgmma;
# K7: two TF32 products on wgmma against int8 weights, which TF32 holds
# exactly; K2, K3: f32 tiles, no products)
KERNEL_META.update({f"{kid}/f32": meta for kid, meta in list(KERNEL_META.items())})
# the arithmetic of each f32 form's products, for its rows
F32_ARITH = {"K1": "3xTF32 wgmma",
             "K4": "3xTF32 wgmma",
             "K5a": "3xTF32 wgmma", "K5b": "3xTF32 wgmma",
             "K6": "3xTF32 wgmma", "K8a": "3xTF32 wgmma",
             "K8b": "3xTF32 wgmma",
             "K7": "2xTF32 wgmma (int8 weights exact in TF32)",
             "K2": "f32, no products", "K3": "f32, no products"}
# the training phases' batch (no CFG doubling), boxes and relation slots
TRAIN_BATCH, TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS = 8, 30, 10
# the int8 generation's images against the dense ones: mean |d| bound of
# the JAX package's int8 test (tests/test_quant.py:152)
INT8_IMAGE_TOL = 0.15
# int8 UNet bytes over its dense bf16 bytes: int8 values, f32 scales per
# output channel, and the small weights, biases and norms left in bf16
INT8_BYTES_RATIO_MAX = 0.55


class Route(NamedTuple):
    """The switches ops/nn.py reads, and whether the UNet is int8."""
    int8: bool = False            # a quantize_unet_int8 bundle
    ffn_int8: bool = False        # LLT2I_FFN_INT8
    ffn_ln: bool = True           # LLT2I_FFN_LN
    pallas_ffn: bool = True       # LLT2I_PALLAS_FFN
    pallas_matmul: bool = False   # LLT2I_PALLAS_MATMUL

    def env(self) -> dict:
        flag = lambda on: "1" if on else "0"
        return {"LLT2I_FFN_INT8": flag(self.ffn_int8),
                "LLT2I_FFN_LN": flag(self.ffn_ln),
                "LLT2I_PALLAS_FFN": flag(self.pallas_ffn),
                "LLT2I_PALLAS_MATMUL": flag(self.pallas_matmul)}


DEFAULT = Route()
INT8 = Route(int8=True, ffn_int8=True)       # phases 7 and 17: K7
INT8_DEQUANT = Route(int8=True)              # the default int8 route
SPLIT = Route(ffn_ln=False, pallas_matmul=True)   # phases 8, 18: K6, K8a, K8b


@contextlib.contextmanager
def route_env(route: Route):
    """Set the route's switches; restore the environment after."""
    saved = {k: os.environ.get(k) for k in route.env()}
    os.environ.update(route.env())
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with ``t_s``: seconds since the script started (the
    phases' place in the run's time limit)."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


class SmokeFailure(Exception):
    pass


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it ("1980 MHz")."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


# ---------------------------------------------------------------------------
# timing and bounds


def _warm_and_size(fn, target_ms: float, max_calls: int = 200):
    """Two warm-up calls, then one timed call: the number of calls that
    fill ~target_ms (at most ``max_calls``), and the host's seconds for
    that one call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    fn()
    e1.record()
    host_s = time.perf_counter() - t0
    e1.synchronize()
    once = max(e0.elapsed_time(e1), 1e-3)
    return int(min(max_calls, max(3, target_ms / once))), host_s


def time_ms(fn, target_ms: float = 60.0, max_calls: int = 200) -> float:
    """Mean ms per call: warm-up, then CUDA events around a run of launches
    sized to ~target_ms, issued back to back from the host. A call whose
    kernels run shorter than its launch path on the host is timed by the
    host (the ``ms`` of every row); ``device_time`` takes the host out."""
    iters, _ = _warm_and_size(fn, target_ms, max_calls)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_time(fn, target_ms: float = 60.0, max_calls: int = 200):
    """(device ms, host us) per call. The run of launches is queued behind
    a device-side sleep that outlasts the host's enqueueing of it, so the
    device takes the calls back to back and its events time the kernels
    alone; the host's seconds to enqueue the run, over its calls, are the
    launch path's cost. If the sleep ended before the host was done, the
    run is made again behind one twice as long."""
    iters, host_s = _warm_and_size(fn, target_ms, max_calls)
    sleep_s = min(max(2.0 * iters * host_s, 2e-3), 1.0)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(sleep_s * max_sm_clock_hz()))
        t0 = time.perf_counter()
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        enqueue_s = time.perf_counter() - t0
        still_asleep = not e0.query()
        e1.synchronize()
        if still_asleep or sleep_s >= 1.0:
            break
        sleep_s = min(2.0 * sleep_s, 1.0)
    return e0.elapsed_time(e1) / iters, enqueue_s / iters * 1e6


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_mem = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def is_f32(args) -> bool:
    """A case of a kernel's f32 form: its args end in "f32"."""
    return args[-1] == "f32"


def split_world(args) -> int:
    """The ranks of a K2 case of the split pair ('spatial' TP: its args
    carry "split<world>", HW one rank's rows), else 0."""
    tag = next((a for a in args if isinstance(a, str) and a.startswith("split")),
               None)
    return int(tag[5:]) if tag else 0


def has_lse(args) -> bool:
    """A K1 case that also writes the lse (a training site)."""
    return "lse" in args


def row_kid(kid, args) -> str:
    """The id a case's row is summed and held under: "K1/f32" for an f32
    case, "K1" for bf16 (kernels/tolerance.py tol_id's ids)."""
    return f"{kid}/f32" if is_f32(args) else kid


def flops_peak(kid, args) -> float:
    """The card's peak for a case's operations: the f32 forms' products run
    on the tensor cores in TF32 (3xTF32 takes three, so no f32 kernel can
    beat this bound), K2's and K3's f32 rows have no products (the f32 rate
    outside the tensor cores), every bf16 case runs in bf16."""
    if not is_f32(args):
        return H100_BF16_FLOPS
    return H100_F32_FLOPS if kid in ("K2", "K3") else H100_TF32_FLOPS


def exp_ms(exps: float, clock_hz: float) -> float:
    """ms for ``exps`` exponentials at the SFUs' rate: every SM's 16 a
    clock at the card's maximum SM clock. Attention takes one a score,
    which at d 40 outlasts the tensor cores' share (``bound``)."""
    return exps / (H100_SMS * MUFU_PER_SM_CLOCK * clock_hz) * 1e3


# ---------------------------------------------------------------------------
# main-path shapes: every kernel call of a generation and of a training step,
# walked from the model configs in the order the models make them


def attention_calls(b, n, m, heads, c, lse=False):
    """K1 where multi_head_attention routes an unmasked site to it (its
    args: b, n, m, heads, d, then "lse" at a site that autograd records)."""
    from layoutllm_t2i_torch.ops.attention import FLASH_MIN_KV, FLASH_MIN_Q_LEN

    if n >= FLASH_MIN_Q_LEN and m >= FLASH_MIN_KV:
        return [("K1", (b, n, m, heads, c // heads) + (("lse",) if lse else ()))]
    return []


def geglu_ff_calls(route, m, k):
    """ops/nn.py geglu_ff on m rows of width k (inner 4k): K8b, then K8a
    for the down-projection, where LLT2I_PALLAS_MATMUL=1 and _eligible."""
    from layoutllm_t2i_torch.kernels.matmul import _eligible

    inner = 4 * k
    if not route.pallas_matmul:
        return []
    if _eligible(m, k, inner):
        calls = [("K8b", (m, k, inner))]
    elif _eligible(m, k, 2 * inner):      # linear(net.0.proj)
        calls = [("K8a", (m, k, 2 * inner))]
    else:
        calls = []
    if _eligible(m, inner, k):            # linear(net.2)
        calls.append(("K8a", (m, inner, k)))
    return calls


def ff_site_calls(route, m, k, s, itemsize=2):
    """One LN + GEGLU FF + residual site of m rows and width k, in the
    fall-through order of ops/nn.py: s = 1.0 is the norm3 site
    (ln_geglu_ff_res), s = 0.5 stands for a fuser's traced gate
    (ln_geglu_ff_scaled_res, which never takes K6). K7's site asks
    ffn_eligible with the activations' item size, as ops/nn.py does; K4's
    and K6's without it."""
    from layoutllm_t2i_torch.kernels.ffn import ffn_eligible

    eligible = ffn_eligible(m, k, 4 * k)
    if route.pallas_ffn and route.ffn_ln:
        if (route.int8 and route.ffn_int8
                and ffn_eligible(m, k, 4 * k, itemsize)):
            return [("K7", (m, k, s))]
        if not route.int8 and eligible:
            return [("K4", (m, k, s))]
    calls = [("K3", (m, k))]
    if s == 1.0 and route.pallas_ffn and not route.int8 and eligible:
        return calls + [("K6", (m, k))]
    return calls + geglu_ff_calls(route, m, k)


def unet_calls(cfg, b, n_obj, n_rel, ctx_len, train=False, route=DEFAULT,
               gated=True, encoder=True, itemsize=2):
    """One UNet forward at batch b, n_obj grounding tokens, n_rel relations,
    on ``route``, its activations of ``itemsize`` bytes. With ``train``
    (rela_fuse mode) autograd records every call from the first relation
    fuser on, so the flash sites there take the lse. ``gated=False``: a
    step with grounding alpha 0, whose body elides the gated fusers;
    ``encoder=False``: a propagated step of the encoder cache, which skips
    input_blocks."""
    from layoutllm_t2i_torch.models.unet import input_block_specs, output_block_specs

    lat, heads = cfg.image_size, cfg.num_heads
    calls = []
    grad = False

    def res(hw, ci, co):
        calls.extend([("K2", (b, hw, ci, 1e-5, True)), ("K2", (b, hw, co, 1e-5, True))])

    def st(hw, c):
        nonlocal grad
        calls.append(("K2", (b, hw, c, 1e-6, False)))
        for _ in range(cfg.transformer_depth):
            calls.append(("K3", (b * hw, c)))                        # attn1
            calls.extend(attention_calls(b, hw, hw, heads, c, grad))
            if gated:                                                # fuser
                calls.append(("K3", (b * (hw + n_obj), c)))
                calls.extend(attention_calls(b, hw + n_obj, hw + n_obj, heads,
                                             c, grad))
                calls.extend(ff_site_calls(route, b * hw, c, 0.5, itemsize))
            if cfg.use_relation_attention:                           # rela_fuse
                grad = grad or train
                calls.extend([("K3", (b * hw, c)), ("K3", (b * n_obj, c))])
                calls.extend(attention_calls(b, n_obj, n_rel, heads, c, grad))
                calls.append(("K3", (b * n_obj, c)))
            calls.append(("K3", (b * hw, c)))                        # attn2
            calls.extend(attention_calls(b, hw, ctx_len, heads, c, grad))
            calls.extend(ff_site_calls(route, b * hw, c, 1.0, itemsize))  # ff

    for kind, ci, co, ds in input_block_specs(cfg) if encoder else ():
        if kind in ("res", "res_st"):
            res((lat // ds) ** 2, ci, co)
        if kind == "res_st":
            st((lat // ds) ** 2, co)
    mid = cfg.model_channels * cfg.channel_mult[-1]
    hw = (lat // 2 ** (len(cfg.channel_mult) - 1)) ** 2
    res(hw, mid, mid)
    st(hw, mid)
    res(hw, mid, mid)
    for kind, ci, _skip, co, _up, ds in output_block_specs(cfg):
        res((lat // ds) ** 2, ci, co)
        if kind == "res_st":
            st((lat // ds) ** 2, co)
    calls.append(("K2", (b, lat * lat, cfg.model_channels, 1e-5, True)))
    return calls


def vae_res_calls(b, hw, ci, co):
    return [("K2", (b, hw, ci, 1e-6, True)), ("K2", (b, hw, co, 1e-6, True))]


def vae_mid_calls(b, hw, c):
    return (vae_res_calls(b, hw, c, c) + [("K2", (b, hw, c, 1e-6, False))]
            + attention_calls(b, hw, hw, 1, c) + vae_res_calls(b, hw, c, c))


def vae_encoder_calls(cfg, b, side):
    """The VAE encoder on (b, 3, side, side) images."""
    calls, block_in = [], cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        for _ in range(cfg.num_res_blocks):
            calls += vae_res_calls(b, side * side, block_in, cfg.ch * mult)
            block_in = cfg.ch * mult
        if i != len(cfg.ch_mult) - 1:
            side //= 2
    calls += vae_mid_calls(b, side * side, block_in)
    return calls + [("K2", (b, side * side, block_in, 1e-6, True))]


def vae_decoder_calls(cfg, b, side):
    """The VAE decoder on (b, 4, side, side) latents."""
    block_in = cfg.ch * cfg.ch_mult[-1]
    calls = vae_mid_calls(b, side * side, block_in)
    for i in reversed(range(len(cfg.ch_mult))):
        for _ in range(cfg.num_res_blocks + 1):
            calls += vae_res_calls(b, side * side, block_in, cfg.ch * cfg.ch_mult[i])
            block_in = cfg.ch * cfg.ch_mult[i]
        if i:
            side *= 2
    return calls + [("K2", (b, side * side, block_in, 1e-6, True))]


def clip_calls(clip_cfg, rows):
    """The CLIP text encoder on ``rows`` token rows (its attention is
    causal, so masked: it never routes to K1)."""
    return [("K3", (rows, clip_cfg.hidden_size))] * (2 * clip_cfg.num_layers + 1)


def unet_evaluations(pipe, b, inpaint: bool = False):
    """(batch, gated, encoder) of every UNet evaluation of ``pipe`` for b
    requests: utils/flops.py's, which counts the FLOPs of the same list
    (under ``inpaint`` without the encoder cache, which inpainting turns
    off)."""
    from layoutllm_t2i_torch.utils.flops import unet_evaluations as evals

    return evals(pipe, b, inpaint=inpaint)


def generation_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, requests,
                     vae_chunk, max_objs=30, max_relas=5, route=DEFAULT,
                     evals=None, f32=False, distinct=True):
    """InferencePipeline.generate: prompts and empty prompts, then every
    phrase and relation text in one batch, each padded to a power of two;
    the UNet on ``route`` at each distinct evaluation of ``evals``
    (utils/flops.py unet_evaluations; default the CFG-doubled full forward,
    which holds every call of the exact path), or at every evaluation with
    ``distinct`` False (the calls as many times as they are made); the VAE
    decode in chunks. ``f32``: an f32 bundle, every call an f32 case."""
    from layoutllm_t2i_torch.utils.buckets import pow2_bucket

    prompts, layouts, relations = requests
    b = len(prompts)
    n_texts = (sum(len(phrases) for _, phrases in layouts)
               + sum(min(len(r), max_relas) for r in relations))
    calls = 2 * clip_calls(clip_cfg, pow2_bucket(b) * tok_len)
    if n_texts:
        calls += clip_calls(clip_cfg, pow2_bucket(n_texts) * tok_len)
    evals = evals or [(2 * b, True, True)]
    for batch, gated, encoder in (sorted(set(evals)) if distinct else evals):
        calls += unet_calls(unet_cfg, batch, max_objs, max_relas, tok_len,
                            route=route, gated=gated, encoder=encoder,
                            itemsize=4 if f32 else 2)
    for i in range(0, b, vae_chunk):
        calls += vae_decoder_calls(vae_cfg, min(vae_chunk, b - i), unet_cfg.image_size)
    return f32_calls(calls) if f32 else calls


def training_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, batch, max_boxes,
                   max_relations, f32=False, route=DEFAULT):
    """One DiffusionTrainer step on a host batch: prepare_batch (VAE
    encode, CLIP on the captions, then every phrase and relation text in
    one power-of-two batch), always in f32 as the JAX trainer encodes, and
    the UNet forward of the loss on ``route``, in f32 with ``f32`` (the
    trainer's default precision), else in bf16 (mixed precision), at the
    latent size the VAE gives the batch's images (96^2 at 768^2, whatever
    the UNet config's image_size, which only sampling reads)."""
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_training
    from layoutllm_t2i_torch.utils.buckets import pow2_bucket

    b, side = len(batch["caption"]), batch["image"].shape[1]
    unet_cfg = dataclasses.replace(
        unet_cfg, image_size=side // 2 ** (len(vae_cfg.ch_mult) - 1))
    n_texts = (sum(min(len(labels), max_boxes) for labels in batch["labels"])
               + sum(len(relation_texts_for_training(c, max_relations))
                     for c in batch["caption"]))
    calls = vae_encoder_calls(vae_cfg, b, side) + clip_calls(clip_cfg, b * tok_len)
    if n_texts:
        calls += clip_calls(clip_cfg, pow2_bucket(n_texts) * tok_len)
    unet = unet_calls(unet_cfg, b, max_boxes, max_relations, tok_len, train=True,
                      route=route, itemsize=4 if f32 else 2)
    return f32_calls(calls) + (f32_calls(unet) if f32 else unet)


def launches_of(calls) -> dict:
    """{row id: launches} of a walk with its calls as many times as they
    are made; each K1 site with its lse also launches K5a and K5b once."""
    counts = {}
    for kid, args in calls:
        kids = [kid] + (["K5a", "K5b"] if kid == "K1" and has_lse(args) else [])
        for k in kids:
            counts[row_kid(k, args)] = counts.get(row_kid(k, args), 0) + 1
    return counts


def case_label(kid, args):
    f32 = " f32" if is_f32(args) else ""
    if kid in ("K1", "K5a", "K5b"):
        b, n, m, h, d = args[:5]
        return f"B{b} N{n} M{m} H{h} d{d}" + (" lse" if has_lse(args) else "") + f32
    if kid == "K2":
        n, hw, c, eps, silu = args[:5]
        world = split_world(args)
        return (f"N{n} HW{hw} C{c} eps{eps:g} silu{int(silu)}"
                + (f" split over {world} ranks" if world else "") + f32)
    if kid == "K3":
        return "rows{} C{}".format(*args) + (
            f" eps{args[2]:g}" if len(args) > 2 and args[2] != "f32" else "") + f32
    if kid == "K6":
        return "M{} K{}".format(*args) + (
            f" inner{args[2]}" if len(args) > 2 and args[2] != "f32" else "") + f32
    if kid in ("K8a", "K8b"):
        return "M{} K{} N{}".format(*args) + f32
    return "M{} K{} s{:g}".format(*args) + f32


def kernel_cases(paths):
    """(kid, label, args, path names) at every distinct shape of the given
    {path name: calls}; each K1 site with its lse is also a K5a and a K5b
    case (the backward of that site)."""
    where = {}
    for path, calls in paths.items():
        for kid, args in calls:
            where.setdefault((kid, args), []).append(path)
            if kid == "K1" and has_lse(args):
                for bwd in ("K5a", "K5b"):
                    where.setdefault((bwd, args[:5] + args[6:]), []).append(path)
    order = list(KERNEL_META)
    keys = sorted(where, key=lambda key: order.index(row_kid(*key)))
    return [(kid, case_label(kid, args), args, sorted(set(where[kid, args])))
            for kid, args in keys]


def make_case(kid, args, dev, gen):
    """(kernel_fn, plain_fn, library_fn, flops, bytes) on fresh inputs of
    the case's type: bf16, or f32 for an f32 case (its library call in f32
    too, with allow_tf32 off)."""
    from layoutllm_t2i_torch import kernels as K

    dt = torch.float32 if is_f32(args) else torch.bfloat16
    item = 4 if is_f32(args) else 2
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(dt)
    if kid == "K1" and has_lse(args):
        return make_lse_case(args[:5], dev, rnd, item)
    if kid in ("K5a", "K5b"):
        return make_bwd_case(kid, args[:5], dev, rnd, item)
    if kid == "K1":
        b, n, m, h, d = args[:5]
        q, k, v = rnd(b, n, h * d), rnd(b, m, h * d), rnd(b, m, h * d)
        sc = d ** -0.5
        heads = lambda t: t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                     scale=sc)
        flops = 4.0 * b * h * n * m * d
        nbytes = item * (2 * b * n * h * d + 2 * b * m * h * d)
        return (lambda: K.flash_attention(q, k, v, h, sc),
                per_batch(lambda *t: K.flash_attention_plain(*t, h, sc),
                          (q, k, v), b * h * n * m), lib, flops, nbytes)
    if kid == "K2" and split_world(args):
        return make_split_case(args, rnd, item)
    if kid == "K2":
        n, hw, c, eps, silu = args[:5]
        x = rnd(n, hw, c, scale=2.0) + 0.5
        w, bb = rnd(c, scale=0.5) + 1.0, rnd(c, scale=0.5)
        side = int(math.isqrt(hw))

        def lib():
            y = F.group_norm(x.view(n, side, side, c).permute(0, 3, 1, 2), 32,
                             w, bb, eps)
            return F.silu(y) if silu else y
        return (lambda: K.group_norm(x, w, bb, 32, eps, silu),
                lambda: K.group_norm_plain(x, w, bb, 32, eps, silu), lib,
                10.0 * x.numel(), item * (2 * x.numel() + 2 * c))
    if kid == "K3":
        rows, c = args[:2]
        # ConvNeXt's rows carry their eps 1e-6; every other site's is 1e-5
        eps = args[2] if len(args) > 2 and args[2] != "f32" else 1e-5
        x = rnd(rows, c, scale=2.0) + 0.5
        w, bb = rnd(c, scale=0.5) + 1.0, rnd(c, scale=0.5)
        return (lambda: K.layer_norm(x, w, bb, eps),
                lambda: K.layer_norm_plain(x, w, bb, eps),
                lambda: F.layer_norm(x, (c,), w, bb, eps),
                8.0 * x.numel(),
                x.element_size() * (2.0 * x.numel() + 2 * c))
    if kid in ("K8a", "K8b"):
        return make_gemm_case(kid, args[:3], rnd, item)
    if kid == "K6":
        return make_ffn_res_case(args, rnd, item)
    m, k, s = args[:3]
    inner = 4 * k
    x = rnd(m, k)
    lw, lb = rnd(k, scale=0.2) + 1.0, rnd(k, scale=0.2)
    w1, b1 = rnd(2 * inner, k, scale=k ** -0.5), rnd(2 * inner, scale=0.1)
    w2, b2 = rnd(k, inner, scale=inner ** -0.5), rnd(k, scale=0.1)
    s_t = torch.tensor(s, device=dev, dtype=torch.float32)
    if kid == "K7":
        return make_int8_ffn_case(args[:3], x, lw, lb, w1, b1, w2, b2, s_t, item)

    def lib():
        a, g = F.linear(F.layer_norm(x, (k,), lw, lb, 1e-5), w1, b1).chunk(2, -1)
        return x + s * F.linear(a * F.gelu(g), w2, b2)
    flops = 6.0 * m * k * inner
    nbytes = item * (2 * m * k + 3 * inner * k + 2 * inner + 3 * k)
    return (lambda: K.ffn_ln_geglu(x, lw, lb, w1, b1, w2, b2, s_t),
            lambda: K.ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, s_t),
            lib, flops, nbytes)


def make_split_case(args, rnd, item=2):
    """K2's split pair as rank 0 of ``world`` runs it: its statistics
    launch, every rank's partials (made here by the other blocks' statistics
    launches, as the gather would hand them over), its apply launch.
    Against the plain GroupNorm of the whole rows, rank 0's block. No single
    library call computes this function (library_fn None); the bound counts
    one rank's rows read and written once and the partials read."""
    gn = importlib.import_module("layoutllm_t2i_torch.kernels.group_norm")
    n, hw, c, eps, silu = args[:5]
    world = split_world(args)
    x = rnd(n, world * hw, c, scale=2.0) + 0.5
    w, bb = rnd(c, scale=0.5) + 1.0, rnd(c, scale=0.5)
    blocks = [blk.contiguous() for blk in x.chunk(world, dim=1)]
    parts = []
    for blk in blocks:
        gn.group_norm_split(blk, w, bb, 32, eps, silu,
                            lambda part: parts.append(part.clone()) or part)
    every = torch.cat(parts, dim=2)
    return (lambda: gn.group_norm_split(blocks[0], w, bb, 32, eps, silu,
                                        lambda part: every),
            lambda: gn.group_norm_plain(x, w, bb, 32, eps, silu)[:, :hw],
            None, 10.0 * blocks[0].numel(),
            item * (2 * blocks[0].numel() + 2 * c) + 4 * every.numel())


def make_ffn_res_case(args, rnd, item=2):
    """K6: the FF without the LN, its residual passed in, at inner 4k or
    at the inner width ``args`` carries (a 'heads' rank's slice). Library:
    the FF as F.linear, GEGLU, F.linear, then the residual add. Operands
    of ``item`` bytes."""
    from layoutllm_t2i_torch import kernels as K

    m, k = args[:2]
    inner = args[2] if len(args) > 2 and args[2] != "f32" else 4 * k
    x, r = rnd(m, k), rnd(m, k)
    w1, b1 = rnd(2 * inner, k, scale=k ** -0.5), rnd(2 * inner, scale=0.1)
    w2, b2 = rnd(k, inner, scale=inner ** -0.5), rnd(k, scale=0.1)

    def lib():
        a, g = F.linear(x, w1, b1).chunk(2, -1)
        return F.linear(a * F.gelu(g), w2, b2) + r
    flops = 6.0 * m * k * inner
    nbytes = item * (3 * m * k + 3 * inner * k + 2 * inner + k)
    return (lambda: K.ffn_geglu(x, w1, b1, w2, b2, r),
            lambda: K.ffn_geglu_plain(x, w1, b1, w2, b2, r), lib, flops,
            nbytes)


def make_int8_ffn_case(args, x, lw, lb, w1, b1, w2, b2, s_t, item=2):
    """K7 on K4's inputs with w1 and w2 quantized as quantize_unet_int8
    quantizes them. Library: dequantize, then K4's library chain. The
    bound counts the weights at one byte each, the scales at four, the
    other operands at ``item``."""
    from layoutllm_t2i_torch import kernels as K
    from layoutllm_t2i_torch.ops.quant import quantize_tensor

    m, k, s = args
    inner = 4 * k
    qw1, qw2 = quantize_tensor(w1), quantize_tensor(w2)
    q = (qw1.q, qw1.scale, b1, qw2.q, qw2.scale, b2)

    def lib():
        a, g = F.linear(F.layer_norm(x, (k,), lw, lb, 1e-5), qw1.dequantize(),
                        b1).chunk(2, -1)
        return x + s * F.linear(a * F.gelu(g), qw2.dequantize(), b2)
    flops = 6.0 * m * k * inner
    nbytes = (item * (2 * m * k + 2 * inner + 3 * k) + 3.0 * inner * k
              + 4.0 * (2 * inner + k))
    return (lambda: K.ffn_ln_geglu_q(x, lw, lb, *q, s_t),
            lambda: K.ffn_ln_geglu_q_plain(x, lw, lb, *q, s_t), lib, flops,
            nbytes)


def make_gemm_case(kid, args, rnd, item=2):
    """K8a: x W^T + b (library: F.linear with the bias). K8b: the GEGLU of
    x [Wa; Wg]^T + b (library: F.linear on [Wa; Wg], then a * gelu(g)).
    Operands of ``item`` bytes."""
    from layoutllm_t2i_torch import kernels as K

    m, k, n = args
    x = rnd(m, k)
    if kid == "K8a":
        w, b = rnd(n, k, scale=k ** -0.5), rnd(n, scale=0.1)
        return (lambda: K.linear_fused(x, w, b),
                lambda: K.linear_plain(x, w, b), lambda: F.linear(x, w, b),
                2.0 * m * k * n, item * (m * k + n * k + m * n + n))
    w, b = rnd(2 * n, k, scale=k ** -0.5), rnd(2 * n, scale=0.1)

    def lib():
        a, g = F.linear(x, w, b).chunk(2, -1)
        return a * F.gelu(g)
    return (lambda: K.geglu_fused(x, w, b), lambda: K.geglu_plain(x, w, b),
            lib, 4.0 * m * k * n, item * (m * k + 2 * n * k + m * n + 2 * n))


# a plain attention version whose f32 score tensors (B H N M values) pass
# this runs a batch element at a time: at the 768^2 training sites (8 x 8 x
# 9246^2 scores) one would take 22 GB, and the plain backward holds four
PLAIN_CHUNK_SCORES = 2 ** 30


def per_batch(plain, tensors, scores: int):
    """``plain(*tensors)``, or, past PLAIN_CHUNK_SCORES ``scores``, the
    same function on each batch element's slice of every tensor (dim 0),
    its outputs concatenated: the same values, less memory at once."""
    if scores <= PLAIN_CHUNK_SCORES:
        return lambda: plain(*tensors)

    def run():
        outs = [plain(*(t[i:i + 1] for t in tensors))
                for i in range(tensors[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)
    return run


def make_lse_case(args, dev, rnd, item=2):
    """K1 as the training forward runs it: (out, lse) through the kernel's
    lse output, against the plain forward's (out, lse); operands of
    ``item`` bytes."""
    from layoutllm_t2i_torch import kernels as K
    from layoutllm_t2i_torch.kernels.flash_attention import _launch_fwd

    b, n, m, h, d = args
    q, k, v = rnd(b, n, h * d), rnd(b, m, h * d), rnd(b, m, h * d)
    sc = d ** -0.5
    heads = lambda t: t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                 scale=sc)
    flops = 4.0 * b * h * n * m * d
    nbytes = item * (2 * b * n * h * d + 2 * b * m * h * d) + 4.0 * b * h * n
    return (lambda: _launch_fwd(q, k, v, h, sc, need_lse=True),
            per_batch(lambda *t: K.flash_attention_lse_plain(*t, h, sc),
                      (q, k, v), b * h * n * m), lib, flops, nbytes)


def make_bwd_case(kid, args, dev, rnd, item=2):
    """K5a (dQ) or K5b (dK, dV) on the lse and delta of the plain forward,
    against the plain backward; operands of ``item`` bytes. The library
    call is SDPA's whole backward (dQ, dK and dV in one call): its forward
    plus backward, timed as one closure, minus its forward, timed alone;
    both rows list it."""
    from layoutllm_t2i_torch import kernels as K

    b, n, m, h, d = args
    q, k, v = rnd(b, n, h * d), rnd(b, m, h * d), rnd(b, m, h * d)
    dout = rnd(b, n, h * d, scale=0.1)
    sc = d ** -0.5
    out, lse = per_batch(lambda *t: K.flash_attention_lse_plain(*t, h, sc),
                         (q, k, v), b * h * n * m)()
    delta = K.attention_delta(out, dout, h)
    del out
    plain = per_batch(
        lambda *t: K.flash_attention_bwd_plain(*t, h, sc),
        (q, k, v, dout, lse, delta), b * h * n * m)
    heads = lambda t: t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)
    qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
    doh = heads(dout)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
    lib = (lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), sdpa)
    io = item * 4 * b * n * h * d + 4.0 * 2 * b * h * n  # q, k, v, dO; lse, delta
    if kid == "K5a":
        # S, dP and dQ: three N x M x d products
        return (lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse, delta, h, sc),
                lambda: plain()[0],
                lib, 6.0 * b * h * n * m * d, io + item * b * n * h * d)
    # S, dP, dV and dK: four
    return (lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h, sc),
            lambda: plain()[1:],
            lib, 8.0 * b * h * n * m * d, io + item * 2 * b * m * h * d)


def gn_plan(n, hw, c, groups=32, itemsize=2):
    """K2's plan (kernels/group_norm.py plan_group_norm) for a row label."""
    gn = importlib.import_module("layoutllm_t2i_torch.kernels.group_norm")
    return gn.plan_group_norm(n, hw, c, groups, itemsize)


def unet_eval_device_ms(unet_cfg, tok_len, device_ms_by_args) -> float:
    """K2's device ms in one UNet evaluation of the generation (CFG batch
    4, 30 grounding tokens, 5 relations): phase 2's device_ms at each of
    its K2 shapes, weighted by the number of its calls there."""
    calls = [args for kid, args in unet_calls(unet_cfg, 2 * len(REQUESTS[0]),
                                               30, 5, tok_len) if kid == "K2"]
    return sum(device_ms_by_args[args] for args in calls)


def library_ms(lib, timer=time_ms) -> float:
    """ms of one library call; of a (whole, part) pair, whole minus part."""
    if isinstance(lib, tuple):
        whole, part = lib
        return timer(whole) - timer(part)
    return timer(lib)


# ---------------------------------------------------------------------------
# phases


def sass_opcode_counts(lib_path, opcode: str) -> dict:
    """{kernel function: instructions of ``opcode``} in a built library's
    SASS, as cuobjdump (beside nvcc) disassembles it."""
    from layoutllm_t2i_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def ptxas_kernels(log: str) -> dict:
    """{kernel (mangled): {"registers", "spill_stores", "spill_loads"}} from
    an nvcc log written with -Xptxas -v."""
    found, fn = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
            found[fn] = {}
        elif fn is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found[fn]["spill_stores"], found[fn]["spill_loads"] = nums[1], nums[2]
        elif fn is not None and "Used " in line and " registers" in line:
            found[fn]["registers"] = int(line.split("Used ")[1].split()[0])
    return found


def phase_build():
    from layoutllm_t2i_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build_all()
    # the wgmma kernels must run on the tensor cores' wgmma path (HGMMA in
    # SASS), each in every instantiation
    hgmma, missing, ptxas, c7515 = {}, [], {}, []
    for lib in build.SOURCES:
        text = (build.BUILD_DIR / f"{lib}.log").read_text()
        if "C7515" in text:
            c7515.append(lib)
        names = WGMMA_KERNELS.get(lib, ())
        shown = names + (GN_KERNELS if lib == "group_norm" else ())
        ptxas.update({fn: rec for fn, rec in ptxas_kernels(text).items()
                      if any(name in fn for name in shown)})
        if not names:
            continue
        found = {fn: n for fn, n in sass_opcode_counts(
            build.lib_path(lib), "HGMMA").items()
            if any(name in fn for name in names)}
        hgmma.update(found)
        missing += [name for name in names
                    if not any(name in fn for fn in found)]
    spills = {fn: rec for fn, rec in ptxas.items()
              if any(name in fn for name in NO_SPILL_KERNELS)
              and (rec.get("spill_stores") or rec.get("spill_loads"))}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libs": log, "hgmma": hgmma, "ptxas": ptxas, "c7515": c7515})
    if missing or not all(hgmma.values()):
        raise SmokeFailure(f"tensor-core kernels without HGMMA (wgmma) in "
                           f"their SASS: {hgmma}, none found of {missing}")
    if spills or c7515:
        raise SmokeFailure(f"ptxas spills in {sorted(spills)} or C7515 "
                           f"(serialised wgmma) in the logs of {c7515}")


# an empty C entry point with K3's eight arguments (host_floor)
NOOP_SRC = ('extern "C" __attribute__((visibility("default"))) int llt2i_noop('
            'const void*, const void*, const void*, void*, int, int, float, '
            'void*) { return 0; }\n')


def host_path_checks() -> dict:
    """The wrappers' host path: their raw stream handle is the current
    stream's, outside and inside a torch.cuda.stream block; and the floor
    of a call from Python, torch.empty_like of K3's output plus an empty C
    entry point with K3's eight arguments through ctypes, host us a call
    as device_time measures the wrappers' (K3 at rows 8192, C 320)."""
    import ctypes

    from layoutllm_t2i_torch.kernels import build
    from layoutllm_t2i_torch.kernels.dispatch import stream_handle

    idx = torch.cuda.current_device()
    outside = (stream_handle(idx), torch.cuda.current_stream().cuda_stream)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        inside = (stream_handle(idx), torch.cuda.current_stream().cuda_stream,
                  side.cuda_stream)
    stream_ok = (outside[0] == outside[1] and inside[0] == inside[1] == inside[2]
                 and inside[0] != outside[0])
    work = build.BUILD_DIR.parent / "host_floor"
    work.mkdir(parents=True, exist_ok=True)
    (work / "noop.cu").write_text(NOOP_SRC)
    subprocess.run([build.nvcc_path(), "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(work / "noop.so"), str(work / "noop.cu")], check=True,
                   capture_output=True, timeout=300)
    noop = ctypes.CDLL(str(work / "noop.so")).llt2i_noop
    noop.argtypes = build.SIGNATURES["layer_norm"]["llt2i_layer_norm"]
    noop.restype = ctypes.c_int
    x = torch.zeros(8192, 320, device="cuda", dtype=torch.bfloat16)
    w, b = x[0], x[1]
    out = torch.empty_like(x)
    empty_us = device_time(lambda: torch.empty_like(x))[1]
    call_us = device_time(lambda: noop(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), 8192, 320, 1e-5,
                                       outside[0]))[1]
    rec = {"phase": "host_path", "ok": stream_ok,
           "stream_outside": list(outside), "stream_inside": list(inside),
           "empty_like_us": empty_us, "ctypes_call_us": call_us,
           "host_floor_us": empty_us + call_us}
    emit(rec)
    if not stream_ok:
        raise SmokeFailure("the wrappers' raw stream handle is not the current "
                           "stream's")
    return rec


def path_counts() -> dict:
    """Kernel launches since the counts were last set to 0, each f32 form
    apart: {"K1": bf16 launches, "K1/f32": f32 launches, ...}."""
    from layoutllm_t2i_torch.kernels import f32_launch_counts, launch_counts

    counts, f32 = launch_counts(), f32_launch_counts()
    out = {kid: n - f32.get(kid, 0) for kid, n in counts.items()}
    out.update({f"{kid}/f32": n for kid, n in f32.items()})
    return out


# each timing of a phase kernels row: runs of ~30 ms, at most 100 calls (a
# depth cut for the run's time limit, PERF.md section 4)
KERNELS_TARGET_MS, KERNELS_MAX_CALLS = 30.0, 100


def phase_kernels(cases, acc=None):
    """Every case against its plain version, timed. ``acc``: the
    (summary, pairs, host floor) of an earlier pass, which this pass adds
    its rows to (the second pass takes the shapes that phases inpaint,
    modalities and cli recorded and the first did not hold). Returns
    (summary, pairs, host floor); a summary's ``host_us`` stays a list of
    its rows' (host_us_median takes their median)."""
    from layoutllm_t2i_torch.kernels.flash_attention import kernel_width
    from layoutllm_t2i_torch.kernels.tolerance import agreement, tol_id

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    clock_hz = max_sm_clock_hz()
    row_ms = functools.partial(time_ms, target_ms=KERNELS_TARGET_MS,
                               max_calls=KERNELS_MAX_CALLS)
    row_device_time = functools.partial(device_time, target_ms=KERNELS_TARGET_MS,
                                        max_calls=KERNELS_MAX_CALLS)
    if acc is None:
        host_floor = host_path_checks()
        summary = {kid: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                         "rms_rel_err": 0.0, "ms": 0.0,
                         "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                         "device_ms": 0.0, "library_device_ms": 0.0,
                         "ops_ms": 0.0, "bytes_ms": 0.0, "shapes": 0,
                         "host_us": [], "device_ms_by_args": {}}
                   for kid in KERNEL_META}
        # the K5 pairs' sums, bf16 and f32 apart
        pairs = {}
        for key in ("bf16", "f32"):
            pairs[key] = {k: 0.0 for k in PAIR_SUMS}
            pairs[key]["shapes"], pairs[key]["max_vs_library"] = 0, 0.0
    else:
        summary, pairs, host_floor = acc
    half = {}  # (K5a or K5b, shape) -> its record, until the pair is complete
    failed = []
    for kid, label, args, paths in cases:
        rid = row_kid(kid, args)
        kern, plain, lib, flops, nbytes = make_case(kid, args, dev, gen)
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        # K1 with its lse: the output to K1's tolerance, the lse to its own
        dt = torch.float32 if is_f32(args) else torch.bfloat16
        tid = (tol_id("K1", dt), tol_id("lse", dt)) if has_lse(args) and kid == "K1" \
            else tol_id(kid, dt)
        agree = agreement(tid, out, ref)
        del out, ref
        peak = flops_peak(kid, args)
        b_ms, b_by = bound(flops, nbytes, peak)
        rec = {"phase": "kernels", "kernel": rid, "shape": label, "paths": paths,
               **agree,
               "ms": row_ms(kern), "plain_ms": row_ms(plain),
               "library_ms": lib and library_ms(lib, row_ms), "bound_ms": b_ms,
               "bound_by": b_by}
        if is_f32(args):
            rec["arith"] = F32_ARITH[kid]
        rec["device_ms"], rec["host_us"] = row_device_time(kern)
        rec["library_device_ms"] = lib and library_ms(
            lib, lambda fn: row_device_time(fn)[0])
        if kid in ("K1", "K5a", "K5b"):
            b, n, m, h, d = args[:5]
            rec["exp_ms"] = exp_ms(float(b) * h * n * m, clock_hz)
            # the instantiation the head dim runs on
            rec["width"] = kernel_width(kid, dt, d)
        if kid in VS_LIBRARY_KIDS and lib:
            rec["vs_library"] = rec["ms"] / rec["library_ms"]
            rec["device_vs_library"] = rec["device_ms"] / rec["library_device_ms"]
        if kid == "K2" and split_world(args):
            plan = importlib.import_module(
                "layoutllm_t2i_torch.kernels.group_norm").stream_plan(
                    *args[:3], 32)
            rec.update(path="split", ranks=split_world(args), slab=plan.slab,
                       chunks=plan.chunks)
        elif kid == "K2":
            plan = gn_plan(*args[:3], itemsize=4 if is_f32(args) else 2)
            rec.update(path=plan.path, cluster=plan.cluster, slab=plan.slab)
        emit(rec)
        if kid in ("K5a", "K5b"):
            half[kid, label] = rec
            if ("K5a", label) in half and ("K5b", label) in half:
                pair_record(half["K5a", label], half["K5b", label], args,
                            clock_hz, pairs["f32" if is_f32(args) else "bf16"])
        agg = summary[rid]
        for key in ("max_abs_err", "max_rel_err", "rms_rel_err"):
            agg[key] = max(agg[key], agree[key])
        if not lib:
            # the split pair (no library call): its sums apart, so the
            # kernel's vs_library stays a ratio over the same shapes
            agg = agg.setdefault("split", {"ms": 0.0, "plain_ms": 0.0,
                                           "bound_ms": 0.0, "device_ms": 0.0,
                                           "shapes": 0})
            for key in ("ms", "plain_ms", "bound_ms", "device_ms"):
                agg[key] += rec[key]
            agg["shapes"] += 1
            if not agree["ok"]:
                failed.append(f"{rid} {label}")
            del kern, plain, lib
            torch.cuda.empty_cache()
            continue
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                    "library_device_ms"):
            agg[key] += rec[key]
        agg["ops_ms"] += flops / peak * 1e3
        agg["bytes_ms"] += nbytes / H100_HBM_BYTES * 1e3
        agg["shapes"] += 1
        agg["host_us"].append(rec["host_us"])
        agg["device_ms_by_args"][args] = rec["device_ms"]
        if "width" in rec:   # K1's and K5's sums by instantiation width
            w = agg.setdefault("by_width", {}).setdefault(rec["width"], dict.fromkeys(
                ("ms", "device_ms", "library_ms", "library_device_ms",
                 "bound_ms", "shapes"), 0))
            for key in w:
                w[key] += 1 if key == "shapes" else rec[key]
        if not agree["ok"]:
            failed.append(f"{rid} {label}")
        del kern, plain, lib
        torch.cuda.empty_cache()
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version: {failed}")
    for pair in pairs.values():
        if pair["shapes"]:
            pair["vs_library"] = pair["ms"] / pair["library_ms"]
            pair["device_vs_library"] = pair["device_ms"] / pair["library_device_ms"]
    emit({"phase": "kernels", "rows": len(cases), "host_us_median": {
        kid: host_us_median(agg) for kid, agg in summary.items()},
        "host_floor_us": host_floor["host_floor_us"]})
    return summary, pairs, host_floor


def host_us_median(agg):
    return float(np.median(agg["host_us"])) if agg["host_us"] else None


PAIR_SUMS = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms",
             "exp_ms")


def pair_work(args):
    """(flops, bytes) of the function the K5 pair computes at one shape:
    dQ, dK and dV from q, k, v, dO, lse and delta, as SDPA's backward
    computes them. S, dP, dQ, dK and dV are five N x M x d products, each
    counted once, and every operand is read once and every gradient written
    once, although the pair's design recomputes S and dP in both kernels.
    An f32 case (args ending in "f32") moves 4-byte operands."""
    b, n, m, h, d = args[:5]
    item = 4 if is_f32(args) else 2
    flops = 10.0 * b * h * n * m * d
    # q, dO and dQ; k, v, dK and dV; f32 lse and delta
    nbytes = item * (3 * b * n * h * d + 4 * b * m * h * d) + 4.0 * 2 * b * h * n
    return flops, nbytes


def pair_record(dq, dkv, args, clock_hz, pair) -> None:
    """The K5 pair at one shape: K5a + K5b against SDPA's whole backward,
    the one library call that computes what the pair computes (dQ, dK and
    dV), counted once: the mean of the two rows' timings of it. Its bound
    and ``exp_ms`` are the function's own (``pair_work``, B*H*N*M
    exponentials), not the sum of the two rows'. Adds the pair's numbers to
    the running sums in ``pair``."""
    b, n, m, h = args[:4]
    rec = {"phase": "kernels",
           "kernel": "K5 pair" + (" f32" if is_f32(args) else ""),
           "shape": dq["shape"], "paths": dq["paths"],
           "ok": dq["ok"] and dkv["ok"]}
    for key in ("ms", "device_ms"):
        rec[key] = dq[key] + dkv[key]
    for key in ("library_ms", "library_device_ms"):
        rec[key] = 0.5 * (dq[key] + dkv[key])
    rec["bound_ms"], rec["bound_by"] = bound(*pair_work(args),
                                             flops_peak("K5a", args))
    rec["exp_ms"] = exp_ms(float(b) * h * n * m, clock_hz)
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    rec["device_vs_library"] = rec["device_ms"] / rec["library_device_ms"]
    emit(rec)
    for key in PAIR_SUMS:
        pair[key] += rec[key]
    pair["shapes"] += 1
    pair["max_vs_library"] = max(pair["max_vs_library"], rec["vs_library"])


def set_alphas(tree, value: float) -> int:
    n = 0
    for name, p in tree.named_parameters():
        if name.endswith(("alpha_attn", "alpha_dense")):
            p.data.fill_(value)
            n += 1
    return n


def unet_runner(models):
    """One full-width UNet forward at batch 4 on fixed inputs (seed 1):
    three boxes, five relation slots, timesteps 981 and 501."""
    from layoutllm_t2i_torch.models.unet import unet_apply

    dev, dt = models.device, models.compute_dtype
    cfg = models.unet_cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    b = 4
    x = rnd(b, 4, cfg.image_size, cfg.image_size).to(dt).contiguous(
        memory_format=torch.channels_last)
    t = torch.tensor([981, 981, 501, 501], device=dev)
    ctx = (rnd(b, 77, cfg.context_dim) * 0.5).to(dt)
    boxes = torch.zeros(b, 30, 4, device=dev)
    boxes[:, 0] = torch.tensor([0.1, 0.2, 0.5, 0.9])
    boxes[:, 1] = torch.tensor([0.55, 0.1, 0.95, 0.6])
    boxes[:, 2] = torch.tensor([0.3, 0.5, 0.7, 0.95])
    masks = torch.zeros(b, 30, device=dev)
    masks[:, :3] = 1
    pos = (rnd(b, 30, cfg.grounding_in_dim) * 0.5).to(dt)
    rel = (rnd(b, 5, cfg.context_dim) * 0.5).to(dt)

    @torch.no_grad()
    def run():
        return unet_apply(models.unet_params, cfg, x, t, ctx, boxes, masks,
                          pos, rel, fuser_scale=1.0).float()
    return run


def unet_agreement(out, ref) -> dict:
    """max |a-b| / max |b| of two UNet outputs, against UNET_REL_TOL."""
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(ref).all())
    diff = float((out - ref).abs().max())
    rel_err = diff / max(float(ref.abs().max()), 1e-6)
    return {"ok": finite and rel_err <= UNET_REL_TOL, "max_abs_diff": diff,
            "ref_max_abs": float(ref.abs().max()), "rel_err": rel_err}


def routed_unet(run):
    """``run()`` through the kernels (launches counted from 0), then through
    the plain versions; (kernel output, plain output, kernel launches, each
    f32 form apart (path_counts), whether the plain run launched a
    kernel)."""
    from layoutllm_t2i_torch.kernels import plain_route, reset_launches

    reset_launches()
    out = run()
    torch.cuda.synchronize()
    counts = path_counts()
    with plain_route():
        ref = run()
    torch.cuda.synchronize()
    return out, ref, counts, path_counts() != counts


def phase_unet(models):
    n_alpha = set_alphas(models.unet_params, 0.5)
    out, ref, _, _ = routed_unet(unet_runner(models))
    agree = unet_agreement(out, ref)
    emit({"phase": "unet", "ok": agree["ok"], "alphas_set": n_alpha,
          "shape": list(out.shape), **{k: v for k, v in agree.items() if k != "ok"},
          "tol_rel": UNET_REL_TOL})
    if not agree["ok"]:
        raise SmokeFailure("UNet forward: kernel route disagrees with plain route")


# PLMS steps of the generation phases: the whole script runs well inside the
# time limit at the full 50, so the step count is never lowered
STEPS = 50
VAE_CHUNK = 8

# two requests: a prompt, 2-3 boxes with phrases, 1-2 relation texts each
REQUESTS = (
    ["a dog chasing a red ball on the grass",
     "a cat sitting on a wooden chair next to a lamp"],
    [([[0.05, 0.4, 0.55, 0.95], [0.6, 0.6, 0.85, 0.85]],
      ["a dog", "a red ball"]),
     ([[0.2, 0.1, 0.6, 0.6], [0.15, 0.4, 0.7, 0.98], [0.7, 0.05, 0.95, 0.7]],
      ["a cat", "a wooden chair", "a lamp"])],
    [["dog chasing ball"], ["cat on chair", "lamp next to chair"]],
)


def exact_pipeline(models):
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    return InferencePipeline(models, steps=STEPS, sampler="plms",
                             guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=VAE_CHUNK)


def fast_settings() -> dict:
    """The fast preset as ``cli/serve.py --fast`` expands it
    (pipeline/presets.py): DPM-Solver++ 15 steps, CFG on (0, 0.75), the
    encoder re-run every 2nd step."""
    from layoutllm_t2i_torch.cli.serve import parse_args
    from layoutllm_t2i_torch.pipeline.presets import apply_fast_preset

    a = apply_fast_preset(parse_args(["--fast"]))
    return dict(sampler=a.sampler, steps=a.steps, guidance_scale=a.guidance_scale,
                cfg_interval=a.cfg_interval,
                encoder_cache_interval=a.cache_encoder)


def fast_pipeline(models, vae_chunk=VAE_CHUNK):
    """The fast preset on the generation's alpha (0.3, 0, 0.7). Its step
    tables need only ``models.schedule``."""
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    return InferencePipeline(models, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=vae_chunk, **fast_settings())


def fast_tables_pipeline():
    """fast_pipeline for its step tables alone (random_models' schedule)."""
    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule

    return fast_pipeline(types.SimpleNamespace(
        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012)))


def run_generation(models, label: str, **extra):
    """A 2-step warm-up generation (cuDNN algorithm selection and the first
    kernel launches stay out of the timed run), then PLMS-50 on REQUESTS
    from seed 0 with the launches counted from 0. Returns (record, launch
    counts, images)."""
    from layoutllm_t2i_torch.kernels import reset_launches
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    pipe = exact_pipeline(models)
    prompts, layouts, relations = REQUESTS
    InferencePipeline(models, steps=2, alpha_type=(0.5, 0.0, 0.5),
                      vae_chunk=VAE_CHUNK).generate(prompts, layouts, relations,
                                                    seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    img = pipe.generate(prompts, layouts, relations, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    ok = (img.shape == (2, 512, 512, 3) and bool(np.isfinite(img).all())
          and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)
    grounded = int((pipe.tables.fuser_scale != 0).sum())
    rec = {"phase": label, "ok": ok, **extra, "steps": STEPS,
           "shape": list(img.shape), "min": float(img.min()),
           "max": float(img.max()), "mean": float(img.mean()),
           "std_across_images": float(img.std(axis=0).mean()),
           "wall_s": wall, "img_per_s": len(prompts) / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "unet_evals": STEPS + 1, "grounded_steps": grounded,
           "launches": counts}
    return rec, counts, img


def phase_generate(models):
    rec, counts, img = run_generation(models, "generate")
    emit(rec)
    if not rec["ok"]:
        raise SmokeFailure("generation output is not a finite (2,512,512,3) "
                           "image batch in [0, 1]")
    return counts, img


# phase fast: its images against the exact path's from the same noise
FAST_PSNR_MIN_DB = 30.0
# phase serve: batch 2, three requests (prompt, one box and phrase, a
# relation, a seed): one full batch, one padded
SERVE_BATCH = 2
SERVE_DELAY_MS = 2000.0
SERVE_REQUESTS = (
    ("a dog chasing a red ball on the grass", [0.05, 0.4, 0.55, 0.95], "a dog",
     "dog chasing ball", 11),
    ("a cat sitting on a wooden chair", [0.2, 0.1, 0.6, 0.6], "a cat",
     "cat on chair", 12),
    ("a red car parked by a tree", [0.1, 0.3, 0.7, 0.9], "a red car",
     "car next to tree", 13),
)
# the per-request-seed contract: a request alone and batched with a
# stranger, tests/parity_setup.py's image gate
SERVE_PSNR_MIN_DB = 35.0


def psnr_db(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


@contextlib.contextmanager
def counted_unet_evals(b: int):
    """Count the UNet evaluations that InferencePipeline's denoisers make
    for b requests: CFG (batch 2b) or cond-only (b), key (the encoder runs)
    or propagated (an encoder cache is read)."""
    inference = importlib.import_module("layoutllm_t2i_torch.pipeline.inference")
    real = inference.unet_apply
    counts = {"cfg": 0, "cond_only": 0, "key": 0, "propagated": 0}

    def spy(params, cfg, x, *args, encoder_cache=None, **kw):
        counts["cfg" if x.shape[0] == 2 * b else "cond_only"] += 1
        counts["key" if encoder_cache is None else "propagated"] += 1
        return real(params, cfg, x, *args, encoder_cache=encoder_cache, **kw)

    inference.unet_apply = spy
    try:
        yield counts
    finally:
        inference.unet_apply = real


def phase_fast(models, exact_img):
    """The fast preset at full width on phase 4's bundle, requests and seed
    (the same noise): a short warm-up that takes every new shape (CFG and
    cond-only, key and propagated), then the timed generation with its
    launches and UNet evaluations counted from 0; its images against the
    exact path's."""
    from layoutllm_t2i_torch.kernels import reset_launches
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    prompts, layouts, relations = REQUESTS
    b = len(prompts)
    pipe = fast_pipeline(models)
    InferencePipeline(models, steps=4, sampler="dpm", alpha_type=(0.5, 0.0, 0.5),
                      cfg_interval=(0.0, 0.5), encoder_cache_interval=2,
                      vae_chunk=VAE_CHUNK).generate(prompts, layouts, relations,
                                                    seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with counted_unet_evals(b) as evals:
        t0 = time.perf_counter()
        img = pipe.generate(prompts, layouts, relations, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = path_counts()
    planned = unet_evaluations(pipe, b)
    want = {"cfg": sum(e[0] == 2 * b for e in planned),
            "cond_only": sum(e[0] == b for e in planned),
            "key": sum(e[2] for e in planned),
            "propagated": sum(not e[2] for e in planned)}
    psnrs = [psnr_db(a, e) for a, e in zip(img, exact_img)]
    finite = bool(np.isfinite(img).all())
    launched = all(counts[kid] > 0 for kid in ("K1", "K2", "K3", "K4"))
    ok = (img.shape == (b, 512, 512, 3) and finite
          and float(img.min()) >= 0.0 and float(img.max()) <= 1.0
          and launched and evals == want and min(psnrs) >= FAST_PSNR_MIN_DB)
    emit({"phase": "fast", "ok": ok, **fast_settings(),
          "alpha_type": list(pipe.alpha_type), "shape": list(img.shape),
          "min": float(img.min()), "max": float(img.max()),
          "wall_s": wall, "img_per_s": b / wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "unet_evals": evals, "unet_evals_planned": want,
          "psnr_vs_exact_db": min(psnrs), "psnr_vs_exact_db_each": psnrs,
          "psnr_min_db": FAST_PSNR_MIN_DB, "launches": counts})
    if not ok:
        raise SmokeFailure("fast: an image is off (shape, range, finite), a "
                           "kernel of K1-K4 did not launch, the UNet "
                           "evaluations differ from the tables, or "
                           f"psnr_vs_exact_db < {FAST_PSNR_MIN_DB}")
    return counts, pipe


def png_pixels(png: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all use filter
    0, as the port's writer stores them, decoded by utils/images.py
    read_png (zlib, every chunk's CRC checked)."""
    from layoutllm_t2i_torch.utils.images import read_png

    try:
        return read_png(png)
    except ValueError as exc:
        raise SmokeFailure(str(exc)) from exc


def http_json(conn, method: str, path: str, body=None):
    conn.request(method, path, body=None if body is None else json.dumps(body))
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def phase_serve(pipe):
    """GenerationServer on 127.0.0.1 with the fast pipeline at batch 2:
    /healthz after the warm-up, then three concurrent POSTs (one full
    batch, one padded). Checks the PNGs, /metrics, the padded request
    against pipe.generate on the same padded batch byte for byte, and the
    batched requests against the same, alone (per-request seeds)."""
    import http.client
    import threading

    from layoutllm_t2i_torch.serving.server import GenerationServer, _png_bytes

    srv = GenerationServer(pipe, batch_size=SERVE_BATCH,
                           max_delay_ms=SERVE_DELAY_MS, host="127.0.0.1",
                           port=0, warmup=True)
    srv.start_background()
    t0 = time.perf_counter()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        while http_json(conn, "GET", "/healthz")[0] != 200:
            if time.perf_counter() - t0 > 600:
                raise SmokeFailure("serve: /healthz not 200 after 600 s")
            time.sleep(0.1)
        warm_s = time.perf_counter() - t0
        http_json(conn, "POST", "/metrics/reset")
        replies = {}

        def post(i, prompt, box, phrase, relation, seed):
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
            c.request("POST", "/generate", body=json.dumps({
                "prompt": prompt, "layout": [{"phrase": phrase, "box": box}],
                "relations": [relation], "seed": seed}))
            r = c.getresponse()
            replies[i] = (r.status, r.getheader("Content-Type"), r.read(),
                          time.perf_counter())
            c.close()

        t1 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, *req))
                   for i, req in enumerate(SERVE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        serve_s = time.perf_counter() - t1
        metrics = http_json(conn, "GET", "/metrics")[1]
    finally:
        srv.shutdown()
    statuses = [replies.get(i, (None,))[0] for i in range(len(SERVE_REQUESTS))]
    if statuses != [200] * len(SERVE_REQUESTS):
        raise SmokeFailure(f"serve: /generate answered {statuses}")
    pixels = [png_pixels(replies[i][2]) for i in range(len(SERVE_REQUESTS))]
    # the one worker serves the full batch first: the last reply is the
    # padded batch's
    padded = max(replies, key=lambda i: replies[i][3])
    same_bytes, psnrs, max_d = {}, {}, {}
    for i, (prompt, box, phrase, relation, seed) in enumerate(SERVE_REQUESTS):
        solo = pipe.generate([prompt] * SERVE_BATCH,
                             [([box], [phrase])] * SERVE_BATCH,
                             [[relation]] * SERVE_BATCH,
                             seeds=[seed] * SERVE_BATCH)[0]
        png = _png_bytes(solo)
        same_bytes[i] = png == replies[i][2]
        if i != padded:
            a = pixels[i].astype(np.float64) / 255
            e = png_pixels(png).astype(np.float64) / 255
            psnrs[i], max_d[i] = psnr_db(a, e), float(np.abs(a - e).max())
    want_metrics = {"requests": 3, "batches": 2, "padded_rows": 1, "errors": 0}
    ok = (all(p.shape == (512, 512, 3) for p in pixels)
          and all(replies[i][1] == "image/png" for i in replies)
          and {k: metrics.get(k) for k in want_metrics} == want_metrics
          and same_bytes[padded]
          and min(psnrs.values()) >= SERVE_PSNR_MIN_DB)
    emit({"phase": "serve", "ok": ok, "batch": SERVE_BATCH,
          "warmup_s": warm_s, "serve_s": serve_s,
          "png_bytes": [len(replies[i][2]) for i in sorted(replies)],
          "metrics": metrics, "padded_request": padded,
          "padded_byte_identical": same_bytes[padded],
          "byte_identical_to_solo": same_bytes,
          "batched_vs_alone_max_abs_diff": max(max_d.values()),
          "batched_vs_alone_psnr_db": psnrs,
          "psnr_min_db": SERVE_PSNR_MIN_DB})
    if not ok:
        raise SmokeFailure("serve: a reply is not a 512x512 RGB PNG, /metrics "
                           "is not 3 requests, 2 batches, 1 padded row, 0 "
                           "errors, the padded request differs from "
                           "pipe.generate on its padded batch, or a batched "
                           "request from itself alone")



# phase bench: the port bench's default invocation (cli/bench.py: batch 8,
# iters 3, exact PLMS-50 then the fast preset on the same noise)
BENCH_BATCH = 8
BENCH_PSNR_MIN_DB = 30.0


def bench_requests(b: int = BENCH_BATCH):
    """cli/bench.py's requests: its prompt, two boxes and one relation,
    b times."""
    from layoutllm_t2i_torch.cli import bench

    return [bench.PROMPT] * b, [bench.LAYOUT] * b, [bench.RELATIONS] * b


def bench_pipelines(models):
    """(exact, fast) pipelines of the bench's default run on ``models``
    (for step tables and FLOPs, a namespace with the configs will do)."""
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    kw = dict(guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
              vae_chunk=VAE_CHUNK)
    return (InferencePipeline(models, steps=STEPS, sampler="plms", **kw),
            InferencePipeline(models, **{**kw, **fast_settings()}))


def tables_models():
    """The full-width configs and schedule of random_models, no weights."""
    from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    return types.SimpleNamespace(
        unet_cfg=unet_cfg, vae_cfg=vae_cfg, clip_cfg=clip_cfg, max_objs=30,
        max_relas=5, tokenizer=HashTokenizer(max_length=clip_cfg.max_length),
        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012))


def images_ok(img, b: int) -> bool:
    return (img.shape == (b, 512, 512, 3) and bool(np.isfinite(img).all())
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)


def phase_bench(profile=None):
    """``python -m layoutllm_t2i_torch.cli.bench`` as run with no flags, in
    this process (random weights from seed 0, bf16, batch 8, iters 3): its
    JSON line, then the checks. Launches counted from 0 over its runs."""
    from layoutllm_t2i_torch.cli.bench import Bench, parse_args
    from layoutllm_t2i_torch.kernels import reset_launches
    from layoutllm_t2i_torch.utils.flops import generation_flops

    bench = Bench(parse_args([]))
    reset_launches()
    t0 = time.perf_counter()
    out, images = bench.run()
    wall = time.perf_counter() - t0
    counts = path_counts()
    print(json.dumps(out), flush=True)
    exact, fast = bench_pipelines(tables_models())
    want = {mode: generation_flops(p, BENCH_BATCH)["total"] / BENCH_BATCH / 1e12
            for mode, p in (("exact", exact), ("fast", fast))}
    got = {"exact": out.get("flops_per_image"),
           "fast": out.get("fast_flops_per_image")}
    flops_ok = all(got[m] is not None and math.isclose(got[m], want[m],
                                                       rel_tol=1e-9)
                   for m in want)
    mfu_ok = all(0.0 < out.get(k, 0.0) <= 1.0 for k in ("mfu", "fast_mfu"))
    imgs_ok = (set(images) == {"exact", "fast"}
               and all(images_ok(img, BENCH_BATCH) for img in images.values()))
    psnr = out.get("fast_psnr_vs_exact_db", float("nan"))
    launched = all(counts[kid] > 0 for kid in ("K1", "K2", "K3", "K4"))
    ok = ("fast_error" not in out and psnr >= BENCH_PSNR_MIN_DB and mfu_ok
          and imgs_ok and flops_ok and launched)
    emit({"phase": "bench", "ok": ok, "wall_s": wall,
          "flops_per_image_planned": want, "psnr_min_db": BENCH_PSNR_MIN_DB,
          "images_ok": imgs_ok, "launches": counts})
    if not ok:
        raise SmokeFailure("bench: fast_error, fast_psnr_vs_exact_db < "
                           f"{BENCH_PSNR_MIN_DB}, an mfu outside (0, 1], an "
                           "image off (shape, range, finite), flops_per_image "
                           "not utils/flops.py's, or K1-K4 not launched")
    if profile:
        noise = bench.make_noises(99)[:1]
        profile_device(lambda: bench.run_all(bench.pipe, noise), "profile-bench",
                       os.path.splitext(profile)[0] + "_bench.json",
                       batch=BENCH_BATCH, steps=STEPS)
    return counts


# phase cli: the generation CLIs at full width on the card, one request each
CLI_PROMPT = "a cat sitting on a wooden chair next to a lamp"
CLI_LAYOUT = "cat:[0.2,0.1,0.4,0.5];wooden chair:[0.15,0.45,0.55,0.5]"
CLI_PLANNED_PROMPT = "a dog chasing a red ball on the grass"
CLI_CACHED_LAYOUT = [["dog", [0.1, 0.35, 0.45, 0.5]],
                     ["red ball", [0.6, 0.65, 0.2, 0.2]]]
# the planner's candidate pool: captions, labels, centre-format boxes
CLI_CANDIDATES = [
    {"captions": "a dog running on a beach", "label": ["dog"],
     "bbox": [[0.5, 0.6, 0.4, 0.5]]},
    {"captions": "a cat under a table", "label": ["cat", "table"],
     "bbox": [[0.4, 0.7, 0.3, 0.3], [0.5, 0.5, 0.8, 0.6]]},
    {"captions": "a boy throwing a ball", "label": ["boy", "ball"],
     "bbox": [[0.4, 0.5, 0.3, 0.8], [0.8, 0.3, 0.1, 0.1]]},
    {"captions": "two dogs playing with a frisbee",
     "label": ["dog", "dog", "frisbee"],
     "bbox": [[0.3, 0.6, 0.3, 0.4], [0.7, 0.6, 0.3, 0.4],
              [0.5, 0.2, 0.1, 0.1]]},
    {"captions": "a red car parked by a tree", "label": ["car", "tree"],
     "bbox": [[0.4, 0.7, 0.6, 0.4], [0.8, 0.4, 0.3, 0.8]]},
]


def cli_paths(unet_cfg, vae_cfg, clip_cfg, tok_len) -> list:
    """The calls of the CLIs' runs in phase cli: an exact PLMS-50
    generation of one request (CFG batch 2) for each layout, and the
    planner's CLIP features of the prompt and the candidates' captions."""
    from layoutllm_t2i_torch.pipeline.inference import convert_xywh_to_ltrb
    from layoutllm_t2i_torch.pipeline.planner import extract_prediction
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_inference
    from layoutllm_t2i_torch.utils.buckets import pow2_bucket

    cached = "\n".join(f"{lab}: {box}" for lab, box in CLI_CACHED_LAYOUT)
    calls = clip_calls(clip_cfg,
                       pow2_bucket(1 + len(CLI_CANDIDATES)) * tok_len)
    for prompt, spec in ((CLI_PROMPT, CLI_LAYOUT),
                         (CLI_PLANNED_PROMPT, cached)):
        cats, boxes = extract_prediction(spec)
        rel = relation_texts_for_inference(prompt, 5)
        calls += generation_calls(
            unet_cfg, vae_cfg, clip_cfg, tok_len,
            ([prompt], [([convert_xywh_to_ltrb(b) for b in boxes], cats)],
             [rel]), VAE_CHUNK)
    return calls


def drawn_boxes_ok(pixels, spec: str) -> dict:
    """Every pixel of the layout's box outlines (utils/boxes.py, Pillow's
    rectangle of width 4) is blue, outside the phrase labels' cells."""
    from layoutllm_t2i_torch.pipeline.inference import convert_xywh_to_ltrb
    from layoutllm_t2i_torch.pipeline.planner import extract_prediction
    from layoutllm_t2i_torch.utils import boxes as B

    cats, boxes = extract_prediction(spec)
    h, w = pixels.shape[:2]
    outline = np.zeros((h, w), dtype=bool)
    labels = np.zeros((h, w), dtype=bool)
    for (x0, y0, x1, y1), cat in zip(map(convert_xywh_to_ltrb, boxes), cats):
        outline |= B.outline_mask(h, w, (x0 * w, y0 * h, x1 * w, y1 * h))
        lx0, ly0, lx1, ly1 = B.label_rect(int(np.floor(x0 * w)),
                                          int(np.floor(y0 * h - B.LABEL_OFFSET)),
                                          cat)
        labels[max(ly0, 0):max(ly1, 0), max(lx0, 0):max(lx1, 0)] = True
    want = outline & ~labels
    blue = (pixels == np.array(B.BOX_COLOR, np.uint8)).all(axis=-1)
    return {"outline_pixels": int(want.sum()),
            "blue_on_outline": int((blue & want).sum()),
            "ok": bool(want.any() and blue[want].all())}


def phase_cli(work_dir: str, source01):
    """cli/txt2img.py main with --layout and again through the offline
    planner (a candidate JSON, a layout-cache JSON and a random policy .pt
    written here), cli/gligen_inference.py main with --negative_prompt,
    with --inpaint_image (``source01`` written as a 512^2 PNG), with
    --modality canny --map_path (an edge map of it, 384x512), --modality
    keypoint --keypoints and --modality text_image --image_refs (a crop of
    it), and two POSTs to cli/demo.py's /api/generate on 127.0.0.1, the
    second with the source PNG to inpaint, at full width on the card:
    every PNG decodes to 512x512 RGB, with the layout's box outlines in
    blue where there is a layout. Launches counted from 0 over the runs,
    and their calls recorded. Returns (launches, calls)."""
    import base64
    import http.client
    import threading

    from layoutllm_t2i_torch.cli import demo, gligen_inference, txt2img
    from layoutllm_t2i_torch.kernels import reset_launches
    from layoutllm_t2i_torch.utils.images import png_bytes_uint8, save_png

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    cand, cache = os.path.join(work_dir, "cand.json"), os.path.join(work_dir, "cache.json")
    with open(cand, "w") as f:
        json.dump({"id": list(range(len(CLI_CANDIDATES))),
                   "data": CLI_CANDIDATES}, f)
    with open(cache, "w") as f:
        json.dump({CLI_PLANNED_PROMPT: CLI_CACHED_LAYOUT}, f)
    policy = torch.nn.Linear(768, 128)
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        policy.weight.copy_(torch.randn(128, 768, generator=g) * 0.05)
        policy.bias.zero_()
    policy_path = os.path.join(work_dir, "policy.pt")
    torch.save(policy.state_dict(), policy_path)
    cached_spec = "; ".join(f"{lab}:{box}" for lab, box in CLI_CACHED_LAYOUT)
    to8 = lambda a: np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
    src_png, edge_png, ref_png = (os.path.join(work_dir, f"{name}.png")
                                  for name in ("src", "edges", "ref"))
    save_png(to8(source01), src_png)
    save_png(to8(edge_map(source01[64:448])), edge_png)
    save_png(to8(source01[100:400, 50:330]), ref_png)
    gligen = lambda name, *argv: gligen_inference.main(
        ["--prompt", CLI_PROMPT, "--folder", os.path.join(work_dir, name), *argv])

    reset_launches()
    recording = recorded_calls()
    calls = recording.__enter__()
    t0 = time.perf_counter()
    runs = {
        "txt2img-layout": (txt2img.main([
            "--prompt", CLI_PROMPT, "--layout", CLI_LAYOUT,
            "--num_per_prompt", "1", "--batch_size", "1",
            "--folder", os.path.join(work_dir, "t2i")]), CLI_LAYOUT),
        "txt2img-planner": (txt2img.main([
            "--prompt", CLI_PLANNED_PROMPT, "--cand_path", cand,
            "--layout_cache", cache, "--policy_ckpt_path", policy_path,
            "--num_per_prompt", "1", "--batch_size", "1",
            "--folder", os.path.join(work_dir, "t2i-planner")]), cached_spec),
        "gligen_inference": (gligen_inference.main([
            "--prompt", CLI_PROMPT, "--layout", CLI_LAYOUT,
            "--negative_prompt", "blurry, low quality",
            "--folder", os.path.join(work_dir, "gligen")]), CLI_LAYOUT),
        "gligen_inference-inpaint": (gligen(
            "inpaint", "--layout", CLI_LAYOUT, "--inpaint_image", src_png),
            CLI_LAYOUT),
        "gligen_inference-canny": (gligen(
            "canny", "--modality", "canny", "--map_path", edge_png), None),
        "gligen_inference-keypoint": (gligen(
            "keypoint", "--modality", "keypoint", "--keypoints",
            MODALITY_KEYPOINTS), None),
        "gligen_inference-text_image": (gligen(
            "text_image", "--modality", "text_image", "--layout", CLI_LAYOUT,
            "--image_refs", f"{ref_png};-"), CLI_LAYOUT),
    }
    torch.cuda.empty_cache()
    srv = demo.build_server(demo.parse_args(["--host", "127.0.0.1", "--port", "0"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    replies = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=600)
        body = {"prompt": CLI_PROMPT, "negative": "", "guidance": 7.5,
                "alpha": [0.3, 0.0, 0.7], "seed": 42,
                "boxes": [{"label": "cat", "x": 0.2, "y": 0.1, "w": 0.4, "h": 0.5},
                          {"label": "wooden chair", "x": 0.15, "y": 0.45,
                           "w": 0.55, "h": 0.5}]}
        inpaint = "data:image/png;base64," + base64.b64encode(
            png_bytes_uint8(to8(source01))).decode()
        for name, extra in (("demo", {}), ("demo-inpaint", {"inpaint": inpaint})):
            conn.request("POST", "/api/generate", body=json.dumps({**body, **extra}))
            replies[name] = json.loads(conn.getresponse().read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(60)
        recording.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    counts = path_counts()
    checks = {}
    for name, (paths, spec) in runs.items():
        pixels = [png_pixels(open(path, "rb").read()) for path in paths]
        checks[name] = {"files": [os.path.basename(p) for p in paths],
                        "shape": [list(p.shape) for p in pixels],
                        **(drawn_boxes_ok(pixels[0], spec) if spec else {"ok": True})}
        checks[name]["ok"] = (checks[name]["ok"] and len(pixels) == 1
                              and pixels[0].shape == (512, 512, 3))
    for name, reply in replies.items():
        if "image" in reply:
            pixels = png_pixels(base64.b64decode(reply["image"]))
            checks[name] = {"seconds": reply["seconds"], "layout": reply["layout"],
                            "shape": list(pixels.shape),
                            **drawn_boxes_ok(pixels, CLI_LAYOUT)}
            checks[name]["ok"] = checks[name]["ok"] and pixels.shape == (512, 512, 3)
        else:
            checks[name] = {"ok": False, "reply": reply}
    launched = all(counts[kid] > 0 for kid in ("K1", "K2", "K3", "K4"))
    ok = launched and all(c["ok"] for c in checks.values())
    emit({"phase": "cli", "ok": ok, "wall_s": wall, "checks": checks,
          "launches": counts})
    if not ok:
        raise SmokeFailure("cli: a CLI's PNG is not a 512x512 RGB image (with "
                           "its layout's box outlines), a demo POST gave no "
                           "image, or K1-K4 not launched")
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts, calls


# ---------------------------------------------------------------------------
# phases inpaint and modalities: kernel calls recorded as they are made


@contextlib.contextmanager
def recorded_calls():
    """Every kernel wrapper call that ops/nn.py and ops/attention.py make
    inside the block, as (kid, args) in the walk's terms (an f32 operand's
    args end in "f32"; a K3 call at another eps than 1e-5 carries it;
    K4's and K7's s is 1.0 at the norm3 sites and stands at 0.5 for a
    fuser's gate), appended to the list it yields. Phase kernels' second
    pass takes the new shapes of phases inpaint, modalities and cli from
    these records (tests/test_torch_smoke_shapes.py holds them against the
    CPU test's recorder)."""
    from layoutllm_t2i_torch.kernels.dispatch import needs_grad

    nn_mod = importlib.import_module("layoutllm_t2i_torch.ops.nn")
    attn_mod = importlib.import_module("layoutllm_t2i_torch.ops.attention")
    calls = []
    real = {name: getattr(nn_mod, name) for name in (
        "_group_norm_rows", "_layer_norm_rows", "ffn_ln_geglu", "ffn_geglu",
        "ffn_ln_geglu_q", "linear_fused", "geglu_fused")}
    real_flash = attn_mod.flash_attention
    real_split = nn_mod.group_norm_split
    f32 = lambda x: ("f32",) if x.dtype is torch.float32 else ()
    gate = lambda s: 1.0 if isinstance(s, float) and s == 1.0 else 0.5

    def group_norm(x, w, b, groups, eps, silu):
        calls.append(("K2", (*x.shape, eps, silu) + f32(x)))
        return real["_group_norm_rows"](x, w, b, groups, eps, silu)

    def layer_norm(x, w, b, eps):
        calls.append(("K3", tuple(x.shape) + ((eps,) if eps != 1e-5 else ())
                      + f32(x)))
        return real["_layer_norm_rows"](x, w, b, eps)

    def ffn(x, lw, lb, w1, b1, w2, b2, s):
        calls.append(("K4", (*x.shape, gate(s)) + f32(x)))
        return real["ffn_ln_geglu"](x, lw, lb, w1, b1, w2, b2, s)

    def ffn_res(x, w1, b1, w2, b2, r):
        # a 'heads' rank's inner slice is part of the shape
        inner = w2.shape[1]
        calls.append(("K6", tuple(x.shape) + (
            (inner,) if inner != 4 * x.shape[-1] else ()) + f32(x)))
        return real["ffn_geglu"](x, w1, b1, w2, b2, r)

    def ffn_q(x, lw, lb, q1, s1, b1, q2, s2, b2, s):
        calls.append(("K7", (*x.shape, gate(s)) + f32(x)))
        return real["ffn_ln_geglu_q"](x, lw, lb, q1, s1, b1, q2, s2, b2, s)

    def linear(x, w, b=None, r=None):
        calls.append(("K8a", (*x.shape, w.shape[0]) + f32(x)))
        return real["linear_fused"](x, w, b, r)

    def geglu(x, w, b=None):
        calls.append(("K8b", (*x.shape, w.shape[0] // 2) + f32(x)))
        return real["geglu_fused"](x, w, b)

    def group_norm_split(x, w, b, groups, eps, silu, gather):
        world = importlib.import_module(
            "layoutllm_t2i_torch.parallel.tp").current_tp().mesh.size
        calls.append(("K2", (*x.shape, eps, silu, f"split{world}") + f32(x)))
        return real_split(x, w, b, groups, eps, silu, gather)

    def flash(q, k, v, heads, scale):
        b, n, hc = q.shape
        lse = ("lse",) if needs_grad(q, k, v) else ()
        calls.append(("K1", (b, n, k.shape[1], heads, hc // heads) + lse + f32(q)))
        return real_flash(q, k, v, heads, scale)

    spies = {"_group_norm_rows": group_norm, "_layer_norm_rows": layer_norm,
             "ffn_ln_geglu": ffn, "ffn_geglu": ffn_res,
             "ffn_ln_geglu_q": ffn_q, "linear_fused": linear,
             "geglu_fused": geglu}
    for name, spy in spies.items():
        setattr(nn_mod, name, spy)
    attn_mod.flash_attention = flash
    nn_mod.group_norm_split = group_norm_split
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(nn_mod, name, fn)
        attn_mod.flash_attention = real_flash
        nn_mod.group_norm_split = real_split


def routed_generation(pipe, cond, noise, blend_noise=None) -> dict:
    """``pipe``'s images from ``cond`` and ``noise`` (B, 64, 64, 4), through
    the kernels (launches counted from 0, calls recorded, UNet evaluations
    counted), then through their plain versions on the same inputs (the
    blend's noise too). Returns {img, ref (the plain images), z (the
    kernel run's final latent), counts, calls, evals, wall_s,
    plain_launched}."""
    from layoutllm_t2i_torch.kernels import plain_route, reset_launches

    b = noise.shape[0]
    reset_launches()
    with recorded_calls() as calls, counted_unet_evals(b) as evals:
        t0 = time.perf_counter()
        z = pipe.run_sampler(cond, noise, blend_noise=blend_noise)
        img = pipe.decode(z)
        sync()
        wall = time.perf_counter() - t0
    counts = path_counts()
    with plain_route():
        ref = pipe.decode(pipe.run_sampler(cond, noise, blend_noise=blend_noise))
    sync()
    side = z.shape[1] * 2 ** (len(pipe.models.vae_cfg.ch_mult) - 1)
    return {"img": img.cpu().numpy(), "ref": ref.cpu().numpy(), "z": z,
            "side": side, "counts": counts, "calls": calls, "evals": dict(evals),
            "wall_s": wall, "plain_launched": path_counts() != counts}


def sync() -> None:
    """Wait for the card, where there is one (the CPU test of these
    phases runs them at the small geometry)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def images_in_range(img, b: int, side: int) -> bool:
    return (img.shape == (b, side, side, 3) and bool(np.isfinite(img).all())
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)


def run_record(run: dict, b: int, psnr_min: float,
               kids=("K1", "K2", "K3", "K4")) -> dict:
    """A routed_generation run's record: wall s, each image's PSNR against
    the plain route's, launches; ok when the b images are finite RGB of
    the VAE's side in [0, 1], every PSNR >= psnr_min, each of ``kids``
    (K1-K4, or their f32 forms) launched and the plain route launched
    none."""
    psnrs = [psnr_db(a, e) for a, e in zip(run["img"], run["ref"])]
    ok = (images_in_range(run["img"], b, run["side"]) and min(psnrs) >= psnr_min
          and not run["plain_launched"]
          and all(run["counts"][k] > 0 for k in kids))
    return {"ok": ok, "wall_s": run["wall_s"], "psnr_vs_plain_db": psnrs,
            "launches": run["counts"], "plain_route_launched": run["plain_launched"]}


def add_counts(total: dict, counts: dict) -> dict:
    for kid, n in counts.items():
        total[kid] = total.get(kid, 0) + n
    return total


# phase inpaint: the kernel route's images against plain_route()'s, the
# tests/parity_setup.py image gate
INPAINT_PSNR_MIN_DB = 35.0
# the final latent's kept region against z0, mean |d|. The last step's
# blend (t = 1) leaves sqrt(1 - alphas_cumprod[1]) = 0.0413 of unit noise
# there, E|n| = 0.80, so 0.033 from the noise, and that step's update moves
# it by about 0.012 of its eps (PERF.md section 6): 0.1 is 3x the noise's
# share, and the painted region (the planted inverted mask) reads O(1)
INPAINT_KEPT_TOL = 0.1


def inpaint_inputs(models, source01, seed: int = 0):
    """REQUESTS' inpainting conditioning on ``source01`` (512, 512, 3) in
    [0, 1], both rows: z0 a VAE posterior sample from a generator seeded
    with ``seed`` and each request's boxes as the region to paint
    (cli/gligen_inference.py inpaint_conditioning)."""
    from layoutllm_t2i_torch.cli.gligen_inference import inpaint_conditioning

    prompts, layouts, _ = REQUESTS
    pixels = np.clip(np.round(source01 * 255.0), 0, 255).astype(np.uint8)
    cond = inpaint_conditioning(models, pixels, [], len(prompts), seed)
    mo = max(len(boxes) for boxes, _ in layouts)
    boxes = np.zeros((len(prompts), mo, 4), np.float32)
    for i, (bxs, _) in enumerate(layouts):
        boxes[i, :len(bxs)] = bxs
    from layoutllm_t2i_torch.pipeline.inpaint import draw_masks_from_boxes

    keep = draw_masks_from_boxes(boxes, size=models.unet_cfg.image_size)
    cond["inpaint_mask"] = torch.from_numpy(keep).to(models.device)
    return cond


def kept_region_check(z, z0, keep) -> dict:
    """mean and max |z - z0| over the kept region (keep == 1), against
    INPAINT_KEPT_TOL, and the same statistic over the painted region (the
    planted inverted mask), which must fail it."""
    d = (z.float() - z0.float()).abs().cpu().numpy()
    kept = np.broadcast_to(keep.cpu().numpy() == 1, d.shape)
    rec = {"kept_mean_abs": float(d[kept].mean()), "kept_max_abs": float(d[kept].max()),
           "inverted_mask_mean_abs": float(d[~kept].mean())}
    rec["ok"] = (rec["kept_mean_abs"] <= INPAINT_KEPT_TOL
                 < rec["inverted_mask_mean_abs"])
    return rec


def phase_inpaint(models, dense_img):
    """Inpainting at full width on phase 4's bundle: the source latent a
    VAE encode of phase 4's first image, REQUESTS' boxes the region to
    paint; exact PLMS-50 and the fast preset (its encoder cache off), each
    through the kernels and again through their plain versions; the kept
    region of the exact run's final latent against z0; the fast run's UNet
    evaluations against the uncached step tables; then an inpaint_mode
    UNet (9 input channels: the latent, the masked z0 and the mask) on one
    PLMS-10 generation. Returns (launches, recorded calls)."""
    from layoutllm_t2i_torch.models.initializers import Init, conv_p
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
    from layoutllm_t2i_torch.utils.trees import replace_subtree

    prompts, layouts, relations = REQUESTS
    b, dev, lat = len(prompts), models.device, models.unet_cfg.image_size
    t_phase = time.perf_counter()
    cond0 = inpaint_inputs(models, dense_img[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn(b, lat, lat, 4, generator=gen, device=dev)
    total, calls, recs, ok = {}, [], {}, True
    for name, pipe in (("exact", exact_pipeline(models)),
                       ("fast", fast_pipeline(models))):
        cond = {**pipe.build_cond(prompts, layouts, relations), **cond0}
        blend = torch.randn((len(pipe.tables.t), b, lat, lat, 4), generator=gen,
                            device=dev)
        run = routed_generation(pipe, cond, noise, blend)
        planned = unet_evaluations(pipe, b, inpaint=True)
        want = {"cfg": sum(e[0] == 2 * b for e in planned),
                "cond_only": sum(e[0] == b for e in planned),
                "key": sum(e[2] for e in planned),
                "propagated": sum(not e[2] for e in planned)}
        rec = run_record(run, b, INPAINT_PSNR_MIN_DB)
        rec.update(unet_evals=run["evals"], unet_evals_planned=want)
        rec["ok"] = rec["ok"] and run["evals"] == want
        if name == "exact":
            rec["kept_region"] = kept_region_check(
                run["z"], cond0["inpaint_z0"], cond0["inpaint_mask"])
            rec["ok"] = rec["ok"] and rec["kept_region"]["ok"]
        recs[name] = rec
        ok = ok and rec["ok"]
        add_counts(total, run["counts"])
        calls += run["calls"]
        del pipe, run
    # an inpaint_mode UNet: the latent, then z0 * mask and the mask
    cfg = dataclasses.replace(models.unet_cfg, inpaint_mode=True)
    ini = Init(torch.Generator(device=dev).manual_seed(7), dev,
               models.compute_dtype)
    im_models = dataclasses.replace(
        models, unet_cfg=cfg, sd_first_conv=None, unet_params=replace_subtree(
            models.unet_params, ("input_blocks", "0", "0"),
            conv_p(ini, 3, 3, cfg.first_conv_in_channels, cfg.model_channels)))
    pipe = InferencePipeline(im_models, steps=MODALITY_STEPS, sampler="plms",
                             guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=VAE_CHUNK)
    cond = {**pipe.build_cond(prompts, layouts, relations), **cond0,
            "inpainting_extra": torch.cat([cond0["inpaint_z0"] * cond0["inpaint_mask"],
                                           cond0["inpaint_mask"]], dim=-1)}
    blend = torch.randn((len(pipe.tables.t), b, lat, lat, 4), generator=gen,
                        device=dev)
    run = routed_generation(pipe, cond, noise, blend)
    recs["inpaint_mode"] = {"first_conv_in": cfg.first_conv_in_channels,
                            **run_record(run, b, INPAINT_PSNR_MIN_DB)}
    ok = ok and recs["inpaint_mode"]["ok"]
    add_counts(total, run["counts"])
    calls += run["calls"]
    emit({"phase": "inpaint", "ok": ok, "wall_s": time.perf_counter() - t_phase,
          "psnr_min_db": INPAINT_PSNR_MIN_DB, "kept_tol_mean_abs": INPAINT_KEPT_TOL,
          **recs, "launches": total})
    if not ok:
        raise SmokeFailure("inpaint: an image is off or disagrees with the "
                           "plain route, the kept region is not z0 (or the "
                           "inverted mask passes), the fast preset's UNet "
                           "evaluations are not the uncached tables', or "
                           "K1-K4 not launched")
    return total, calls


# K1 at head dims no model here routes to it, which the C entries take to
# the instantiation of the smallest width that holds them: bf16 d 48 and 72
# (the 48- and 80-wide ones), 504 (512); in both types d 20 (16 heads at
# 320 channels: not whole 16-byte vectors in bf16, so the wrapper's padded
# copy at 24), 96 (128-wide), 256 (512-wide; num_heads 5's 24^2 sites at
# 768^2); and K5a/K5b at 48, 72, 20, 96 and 144 (160-wide), 168 (256-wide)
# and 300 (320-wide; bf16 on the padded copy at 304) through the "lse"
# sites, at N = M = 606 and 1054 (ragged q and KV tails): phase kernels
# holds each against its plain version. K5 at d 256 and 320 is held at the
# gradient checks' own sites (wide_k5_sites). K1 past 512 (the column-group
# kernels), with and without its lse, at the generation's batch: d 520
# (the last group's columns ragged), 640 (one head) and bf16 636 (two: the
# padded copy at 640, whose rows are whole 16-byte vectors) at N = M =
# 1054, d 1280 at 606 (ragged last tiles); each lse site there is also a
# K5a and a K5b row on K5's column-group kernels, as is d 328 (the first
# width past 320: two groups of 168, the last ragged) at N = M = 1054
HEAD_DIM_CALLS = [("K1", (2, 1024, 1024, 8, 48)), ("K1", (2, 1024, 1024, 8, 72)),
                  ("K1", (1, 4096, 4096, 1, 504)),
                  ("K1", (2, 1024, 1024, 8, 48, "lse")),
                  ("K1", (2, 1024, 1024, 8, 72, "lse"))] + [
    ("K1", shape + tag) for tag in ((), ("f32",)) for shape in (
        (2, 1024, 1024, 16, 20), (2, 1024, 1024, 16, 20, "lse"),
        (2, 1024, 1024, 8, 96), (2, 1024, 1024, 8, 96, "lse"),
        (4, 576, 576, 5, 256), (2, 576, 606, 8, 144, "lse"),
        (2, 606, 606, 8, 168, "lse"), (2, 1054, 1054, 2, 300, "lse"),
        (2, 1054, 1054, 2, 328, "lse"))] + [
    ("K1", shape + lse + tag) for tag in ((), ("f32",)) for lse in ((), ("lse",))
    for shape in ((4, 1054, 1054, 1, 520), (4, 1054, 1054, 1, 640),
                  (4, 606, 606, 1, 1280))] + [
    ("K1", (4, 1054, 1054, 2, 636) + lse) for lse in ((), ("lse",))]


# phases hires and heads5: the seed-0 weights at another geometry (neither
# the latent size nor the head count changes a weight: inner = heads x
# d_head = channels): SD-1.4 at 768^2 (96^2 latents; the third level's
# 24^2 sites, 576 tokens and 606 with the grounding tokens, route K1 at
# d 160, and the VAE's mid block K1 at d 512 over 9216 tokens), and
# num_heads 5 at 512^2 (K1 at d 64 at the 64^2 sites, 128 at the 32^2
# sites). Each run: (dtype, PLMS steps), each a depth cut of the
# reference's 50 (PERF.md section 4). Two more geometries train only
# (phase train-hires' gradient checks): num_heads 2 at 512^2 (K5 at d 160
# on the 64^2 sites, 320 on the 32^2 ones) and num_heads 5 at 768^2 (64,
# 128 and 256 on the 96^2, 48^2 and 24^2 sites). Two more generate
# (phases heads1 and hires1) and train (the gradient checks): num_heads 1
# at 512^2 (K1 and K5 at d 320 on the 64^2 sites, 640 on the 32^2 ones)
# and at 768^2 (320, 640 and 1280 on the 96^2, 48^2 and 24^2 sites): K1
# past d 512 and K5 past 320 run the column-group kernels
GEOMETRY = {"hires": dict(image_size=96), "heads5": dict(num_heads=5),
            "heads2": dict(num_heads=2), "hires5": dict(image_size=96, num_heads=5),
            "heads1": dict(num_heads=1), "hires1": dict(image_size=96, num_heads=1)}
GEOMETRY_RUNS = {"hires": ((torch.bfloat16, 10), (torch.float32, 10)),
                 "heads5": ((torch.bfloat16, 10), (torch.float32, 10)),
                 "heads1": ((torch.bfloat16, 10), (torch.float32, 10)),
                 "hires1": ((torch.bfloat16, 10), (torch.float32, 10))}
# the geometries of GEOMETRY_RUNS whose batch-8 training step phase kernels
# does not walk: for the time a 768^2 walk would add (their gradient
# checks train them, and train-ckpt's num_heads 1 run has its walk)
GENERATION_ONLY = ("heads1", "hires1")
# the head dims whose K1 sites each phase holds to the walk's launches, site
# by site (N, M), and those its training check holds K5 to
GEOMETRY_DIMS = {"hires": (160, 512), "heads5": (64, 128), "heads1": (320, 640),
                 "hires1": (320, 512, 640, 1280)}
GEOMETRY_K5_DIMS = {"hires": (40, 80, 160), "heads5": (64, 128),
                    "heads2": (160, 320), "hires5": (64, 128, 256),
                    "heads1": (320, 640), "hires1": (320, 640, 1280)}
GEOMETRY_PSNR_MIN_DB = 35.0   # tests/parity_setup.py's image gate


def geometry_models(name: str, dtype, small: bool = False, device="cuda"):
    """random_models (seed 0) at full width (or ``small``) in ``dtype``,
    its UNet config changed as GEOMETRY[name] says."""
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    models = random_models(small=small, device=device, dtype=dtype, seed=0)
    return dataclasses.replace(models, unet_cfg=dataclasses.replace(
        models.unet_cfg, **GEOMETRY[name]))


def sites_by_dim(calls, kid: str, dims) -> dict:
    """{(d, N, M): calls} of ``kid``'s calls at the head dims ``dims``
    (K5a and K5b: the K1 sites with their lse)."""
    out = collections.Counter()
    for k, args in calls:
        if k == "K1" and args[4] in dims and (kid == "K1" or has_lse(args)):
            out[(args[4], args[1], args[2])] += 1
    return dict(out)


def phase_geometry(name: str, small: bool = False, device="cuda"):
    """Phase hires, heads5, heads1 or hires1: REQUESTS (CFG 7.5, alpha
    (0.3, 0, 0.7)) on the seed-0 weights at GEOMETRY[name], PLMS in bf16
    and in f32 (GEOMETRY_RUNS), each through the kernels and again under
    plain_route() from the same noise: PSNR >= GEOMETRY_PSNR_MIN_DB, K1-K4
    (or their f32 forms) launched, K1's launches the walk's
    (generation_calls over every UNet evaluation) in all and site by site
    at the head dims of GEOMETRY_DIMS[name]. Returns (launches, recorded
    calls). ``small`` and ``device``: the CPU test's small geometry."""
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    t_phase = time.perf_counter()
    b = len(REQUESTS[0])
    total, calls, recs, ok = {}, [], {}, True
    for dtype, steps in GEOMETRY_RUNS[name]:
        f32 = dtype is torch.float32
        models = geometry_models(name, dtype, small, device)
        cfg = models.unet_cfg
        pipe = InferencePipeline(models, steps=steps, sampler="plms",
                                 guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                                 vae_chunk=VAE_CHUNK)
        gen = torch.Generator(device=device).manual_seed(0)
        noise = torch.randn(b, cfg.image_size, cfg.image_size, 4, generator=gen,
                            device=device)
        run = routed_generation(pipe, pipe.build_cond(*REQUESTS), noise)
        walk = generation_calls(cfg, models.vae_cfg, models.clip_cfg,
                                models.clip_cfg.max_length, REQUESTS, VAE_CHUNK,
                                evals=unet_evaluations(pipe, b), f32=f32,
                                distinct=False)
        k1 = "K1/f32" if f32 else "K1"
        kids = tuple(f"{k}/f32" if f32 else k for k in ("K1", "K2", "K3", "K4"))
        sites = sites_by_dim(run["calls"], "K1", GEOMETRY_DIMS[name])
        walked = sites_by_dim(walk, "K1", GEOMETRY_DIMS[name])
        rec = {"dtype": str(dtype).split(".")[1], "steps": steps,
               "image_size": cfg.image_size, "num_heads": cfg.num_heads,
               **run_record(run, b, GEOMETRY_PSNR_MIN_DB, kids),
               "k1_sites": {f"d{d} N{n} M{m}": c for (d, n, m), c in sorted(sites.items())},
               "k1_walked": launches_of(walk)[k1]}
        rec["sites_match_walk"] = (
            sites == walked and run["counts"][k1] == rec["k1_walked"]
            and {d for d, _, _ in sites} == set(GEOMETRY_DIMS[name]))
        rec["ok"] = rec["ok"] and rec["sites_match_walk"]
        recs[rec["dtype"]] = rec
        ok = ok and rec["ok"]
        add_counts(total, run["counts"])
        calls += run["calls"]
        del models, pipe, run
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    emit({"phase": name, "ok": ok, "wall_s": time.perf_counter() - t_phase,
          "card": nvidia_smi_line() if torch.cuda.is_available() else None,
          "geometry": GEOMETRY[name], "psnr_min_db": GEOMETRY_PSNR_MIN_DB,
          "runs": recs, "launches": total})
    if not ok:
        raise SmokeFailure(f"{name}: an image is off or disagrees with the "
                           "plain route, a kernel of the path did not launch, "
                           "or K1's launches at the geometry's head dims are "
                           "not the walk's")
    return total, calls


# phase modalities: PLMS steps of every run, and of phase inpaint's
# inpaint_mode run (a depth cut of the reference's 50, PERF.md section 4,
# which leaves the 768^2 phases room in the run's time limit)
MODALITY_STEPS = 10
MODALITY_PSNR_MIN_DB = 35.0
# keypoint mode's two persons, 17 points each ('x,y;...|...', normalized)
MODALITY_KEYPOINTS = "|".join(
    ";".join(f"{x0 + 0.01 * (k % 5):.3f},{0.15 + 0.04 * k:.3f}" for k in range(17))
    for x0 in (0.25, 0.65))
MODALITY_LAYOUT = ([[0.05, 0.3, 0.5, 0.95], [0.55, 0.2, 0.95, 0.8]],
                   ["a dog", "a red ball"])


def edge_map(img01) -> np.ndarray:
    """A canny-like binary edge map of an image: the luminance gradient's
    magnitude above its 90th percentile, replicated to RGB, (H, W, 3) in
    {0, 1}."""
    lum = img01.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32)
    gy, gx = np.gradient(lum)
    mag = np.hypot(gx, gy)
    edges = (mag > np.percentile(mag, 90)).astype(np.float32)
    return np.repeat(edges[..., None], 3, axis=-1)


def modality_bundle(fuser_type: str, modality: str, small: bool = False,
                    device="cuda"):
    """random_models at full width (or ``small``) in the device's dtype,
    bf16 on the card, (seed 0) with ``fuser_type``, adapted for
    ``modality`` (seed 0), every gated alpha 0.5 (random init leaves them
    0, which would hide a fuser behind tanh(0) = 0)."""
    from layoutllm_t2i_torch.models.initializers import Init
    from layoutllm_t2i_torch.models.unet import init_unet_params
    from layoutllm_t2i_torch.pipeline.loaders import (adapt_models_for_modality,
                                                      random_models)
    from layoutllm_t2i_torch.utils.trees import ParamTree

    models = random_models(small=small, device=device, seed=0)
    if fuser_type != "gatedSA":
        cfg = dataclasses.replace(models.unet_cfg, fuser_type=fuser_type)
        gen = torch.Generator(device=models.device).manual_seed(0)
        models = dataclasses.replace(models, unet_cfg=cfg, unet_params=ParamTree(
            init_unet_params(Init(gen, models.device, models.compute_dtype), cfg)))
    models = adapt_models_for_modality(models, modality, seed=0)
    set_alphas(models.unet_params, 0.5)
    return models


def modality_cond(pipe, modality: str, work_dir: str, source01):
    """The conditioning that cli/gligen_inference.py builds for
    ``modality`` on REQUESTS' two prompts: a map's tokens and extra
    channels from an edge map of ``source01``, the keypoints of two
    persons, or a 2-box layout whose first box has a reference image (a
    crop of ``source01`` written as a PNG and read back)."""
    from layoutllm_t2i_torch.cli import gligen_inference as cli
    from layoutllm_t2i_torch.utils.images import save_png

    prompts = REQUESTS[0]
    b = len(prompts)
    models = pipe.models
    if modality == "text_image":
        cond = pipe.build_cond(prompts, [MODALITY_LAYOUT] * b)
        ref = os.path.join(work_dir, "ref.png")
        h, w = source01.shape[:2]
        crop = source01[h // 5:4 * h // 5, w // 10:2 * w // 3]
        save_png(np.round(crop * 255).astype(np.uint8), ref)
        args = types.SimpleNamespace(clip_vision_ckpt=None, seed=0,
                                     small=models.unet_cfg.image_size < 64,
                                     projection_matrix=None, batch_size=b,
                                     image_refs=f"{ref};-")
        cond["extra_grounding"] = cli.image_ref_grounding(args, models, cond)
        return cond
    cond = pipe.build_cond(prompts, [([], [])] * b)
    if modality == "keypoint":
        cond.update(cli.keypoint_conditioning(models, MODALITY_KEYPOINTS, b))
    else:
        cmap = torch.from_numpy(edge_map(source01))[None].repeat(b, 1, 1, 1)
        cond.update(cli.map_conditioning(models, cmap.to(models.device)))
    return cond


# (name, fuser, modality, PLMS steps); the gatedCA runs' K1 cross-attention
# has M = 196 (map tokens) and M = 136 (8 persons x 17 points)
MODALITY_RUNS = (("canny", "gatedSA", "canny", MODALITY_STEPS),
                 ("keypoint", "gatedSA", "keypoint", MODALITY_STEPS),
                 ("text_image", "gatedSA", "text_image", MODALITY_STEPS),
                 ("gatedSA2-canny", "gatedSA2", "canny", MODALITY_STEPS),
                 ("gatedCA-canny", "gatedCA", "canny", MODALITY_STEPS),
                 ("gatedCA-keypoint", "gatedCA", "keypoint", MODALITY_STEPS))


def phase_modalities(work_dir: str, source01, small: bool = False,
                     device="cuda"):
    """The extra grounding modalities at full width in bf16, random weights
    from seed 0 adapted by adapt_models_for_modality: canny (ConvNeXt-tiny
    at 448^2, the downsampler's 8 channels, gatedSA), keypoint (2
    persons), text_image (the ViT-L/14 vision tower in f32 on one
    reference PNG), a gatedSA2 UNet with map grounding and a gatedCA UNet
    with map and then keypoint grounding (PLMS-10 each): every run's
    images through the kernels against plain_route()'s, K1-K4 launched in
    each, K1 at M = 196 and M = 136 in the gatedCA runs. Returns
    (launches, recorded calls). ``small`` and ``device``: the CPU test's
    small geometry."""
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    t_phase = time.perf_counter()
    b = len(REQUESTS[0])
    total, calls, recs, ok = {}, [], {}, True
    bundles = {}
    lat = 8 if small else 64
    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn(b, lat, lat, 4, generator=gen, device=device)
    for name, fuser, modality, steps in MODALITY_RUNS:
        key = (fuser, modality)
        if key not in bundles:
            bundles.clear()
            torch.cuda.empty_cache()
            bundles[key] = modality_bundle(fuser, modality, small, device)
        models = bundles[key]
        # grounding on every step: no SD first conv over the extra channels
        pipe = InferencePipeline(models, steps=steps, sampler="plms",
                                 guidance_scale=7.5, alpha_type=(1.0, 0.0, 0.0),
                                 vae_chunk=VAE_CHUNK)
        cond = modality_cond(pipe, modality, work_dir, source01)
        run = routed_generation(pipe, cond, noise)
        cross_m = sorted({args[2] for kid, args in run["calls"]
                          if kid == "K1" and args[1] != args[2]})
        want_m = {"canny": 196, "keypoint": 136}[modality] if fuser == "gatedCA" else None
        rec = {"fuser": fuser, "modality": modality, "steps": steps,
               "k1_cross_m": cross_m, **run_record(run, b, MODALITY_PSNR_MIN_DB)}
        rec["ok"] = rec["ok"] and (want_m is None or want_m in cross_m)
        recs[name] = rec
        ok = ok and rec["ok"]
        add_counts(total, run["counts"])
        calls += run["calls"]
        del pipe, cond, run
    bundles.clear()
    torch.cuda.empty_cache()
    emit({"phase": "modalities", "ok": ok, "wall_s": time.perf_counter() - t_phase,
          "psnr_min_db": MODALITY_PSNR_MIN_DB, "runs": recs, "launches": total})
    if not ok:
        raise SmokeFailure("modalities: an image is off or disagrees with the "
                           "plain route, K1-K4 not launched, or a gatedCA run "
                           "launched no K1 at M = 196 / 136")
    shutil.rmtree(work_dir, ignore_errors=True)
    return total, calls


# phase rl: cli/train_rl.py on a fixture written to the build directory,
# 4 COCO-style examples with 512^2 PNGs, at the reference's rollout sampler
# (PLMS-50) and batch (4 rollouts a batch, CFG batch 8)
RL_N = 4
RL_TRAIN = [
    {"img_id": 0, "name": "rl_0.png", "width": 512, "height": 512,
     "captions": "a dog running on the grass with a frisbee",
     "label": ["dog", "frisbee"],
     "bbox": [[0.4, 0.6, 0.4, 0.5], [0.7, 0.3, 0.15, 0.1]]},
    {"img_id": 1, "name": "rl_1.png", "width": 512, "height": 512,
     "captions": "a cat sleeping on a couch", "label": ["cat", "couch"],
     "bbox": [[0.5, 0.45, 0.3, 0.2], [0.5, 0.6, 0.9, 0.6]]},
    {"img_id": 2, "name": "rl_2.png", "width": 512, "height": 512,
     "captions": "a man riding a horse next to a fence",
     "label": ["person", "horse"],
     "bbox": [[0.45, 0.35, 0.2, 0.4], [0.5, 0.6, 0.5, 0.5]]},
    {"img_id": 3, "name": "rl_3.png", "width": 512, "height": 512,
     "captions": "a pizza on a table beside a cup", "label": ["pizza", "cup"],
     "bbox": [[0.45, 0.6, 0.5, 0.35], [0.8, 0.4, 0.15, 0.2]]},
]
RL_CANDIDATES = [
    {"img_id": 10 + i, "name": f"cand_{i}.jpg", "width": 640, "height": 480,
     **c} for i, c in enumerate(CLI_CANDIDATES[:RL_N])]
# the layout cache: caption -> (label, [x, y, w, h]); "puppy" is not a
# COCO-80 label, so the reward maps it through the text tower
RL_LAYOUTS = {
    RL_TRAIN[0]["captions"]: [["puppy", [0.2, 0.35, 0.4, 0.5]],
                              ["frisbee", [0.62, 0.25, 0.15, 0.1]]],
    RL_TRAIN[1]["captions"]: [["cat", [0.35, 0.35, 0.3, 0.2]],
                              ["couch", [0.05, 0.3, 0.9, 0.6]]],
    RL_TRAIN[2]["captions"]: [["person", [0.35, 0.15, 0.2, 0.4]],
                              ["horse", [0.25, 0.35, 0.5, 0.5]]],
    RL_TRAIN[3]["captions"]: [["pizza", [0.2, 0.45, 0.5, 0.35]],
                              ["cup", [0.72, 0.3, 0.15, 0.2]]],
}
RL_NEW_LABELS = 1   # predicted labels outside COCO-80: "puppy"
# the reward's kernel route against its plain route on the same images,
# each component's max |d| (unweighted: clip, aesthetic, max_iou, docsim).
# Both routes run the f32 towers and differ only in K3's summation order
# (~1e-7 of a row's values); through 24 + 12 layers that stays near 1e-6.
# A K3 fault that phase kernels' K3 tolerance would catch (1e-2 of rms)
# moves the cosines by more than 1e-3.
RL_REWARD_TOL = 1e-4
RL_EPOCHS, RL_RESUME_EPOCHS = 2, 1


def f32_calls(calls):
    """The calls of an f32 model: their args end in "f32"."""
    return [(kid, args + ("f32",)) for kid, args in calls]


def vision_calls(vision_cfg, b):
    """The CLIP vision tower on b images: pre_layrnorm and two LNs a layer
    on b x (patches + 1) rows, post_layernorm on the b class tokens."""
    rows = b * (vision_cfg.num_patches + 1)
    c = vision_cfg.hidden_size
    return ([("K3", (rows, c, "f32"))] * (2 * vision_cfg.num_layers + 1)
            + [("K3", (b, c, "f32"))])


def reward_calls(text_cfg, vision_cfg, tok_len, b, new_labels):
    """RewardModel on b rollouts: the captions through the text tower, the
    predicted then the ground-truth images through the vision tower, then
    each predicted label not in COCO-80 (not cached yet) alone through the
    text tower; all f32."""
    calls = f32_calls(clip_calls(text_cfg, b * tok_len))
    calls += vision_calls(vision_cfg, b) + vision_calls(vision_cfg, b)
    for _ in range(new_labels):
        calls += f32_calls(clip_calls(text_cfg, tok_len))
    return calls


def rl_requests():
    """The rollouts of one RL batch as pipe.generate takes them: captions,
    the cached layouts in ltrb, the relation texts cli/train_rl.py makes."""
    from layoutllm_t2i_torch.pipeline.inference import convert_xywh_to_ltrb
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_inference

    captions = [ex["captions"] for ex in RL_TRAIN]
    layouts = [([convert_xywh_to_ltrb(box) for _, box in RL_LAYOUTS[c]],
                [lab for lab, _ in RL_LAYOUTS[c]]) for c in captions]
    return captions, layouts, [relation_texts_for_inference(c, 5) for c in captions]


def rl_calls(unet_cfg, vae_cfg, clip_cfg, text_cfg, vision_cfg, tok_len):
    """The calls of phase rl's training run: the reward's 80 COCO label
    embeddings, the train and candidate captions' features, then a batch:
    the PLMS-50 generation of its 4 rollouts (CFG batch 8) and one reward
    call."""
    from layoutllm_t2i_torch.pipeline.reward import COCO80_LABELS

    calls = f32_calls(clip_calls(text_cfg, len(COCO80_LABELS) * tok_len))
    calls += 2 * f32_calls(clip_calls(text_cfg, RL_N * tok_len))
    calls += generation_calls(unet_cfg, vae_cfg, clip_cfg, tok_len,
                              rl_requests(), VAE_CHUNK)
    return calls + reward_calls(text_cfg, vision_cfg, tok_len, RL_N,
                                RL_NEW_LABELS)


def rl_fixture(work_dir: str) -> dict:
    """train2014_{train,candidate}_4.json in the reference schema, the
    layout cache, and the 4 train images as 512^2 PNGs (utils/images.py)."""
    from layoutllm_t2i_torch.utils.images import png_bytes

    data, imgs = os.path.join(work_dir, "data"), os.path.join(work_dir, "imgs")
    os.makedirs(data)
    os.makedirs(imgs)
    for name, examples in (("train", RL_TRAIN), ("candidate", RL_CANDIDATES)):
        with open(os.path.join(data, f"train2014_{name}_{RL_N}.json"), "w") as f:
            json.dump({"id": [ex["img_id"] for ex in examples],
                       "data": examples}, f)
    rng = np.random.default_rng(0)
    for ex in RL_TRAIN:
        with open(os.path.join(imgs, ex["name"]), "wb") as f:
            f.write(png_bytes(rng.uniform(size=(512, 512, 3))))
    cache = os.path.join(work_dir, "layouts.json")
    with open(cache, "w") as f:
        json.dump(RL_LAYOUTS, f)
    return {"data": data, "imgs": imgs, "cache": cache,
            "ckpt_root": os.path.join(work_dir, "ckpt")}


def rl_argv(fx: dict, *extra) -> list:
    return ["--img_dir", fx["imgs"], "--sampled_data_dir", fx["data"],
            "--train_number", str(RL_N), "--cand_number", str(RL_N),
            "--batch_size", str(RL_N), "--layout_cache", fx["cache"],
            "--ckpt_root", fx["ckpt_root"], *extra]


def reward_check(fx: dict) -> dict:
    """RewardModel at full width (CLIP ViT-L/14 text and vision towers in
    f32, the aesthetic MLP; random weights from seed 0, as cli/train_rl.py
    builds them) on 4 rollouts of the exact pipeline (the CLI's
    generate_fn): every component through the kernels, then again under
    plain_route() on the same images."""
    from layoutllm_t2i_torch import kernels as K
    from layoutllm_t2i_torch.cli import train_rl
    from layoutllm_t2i_torch.data.rl_data import RLBatches
    from layoutllm_t2i_torch.pipeline.planner import center2lefttop

    args = train_rl.parse_args(rl_argv(fx))
    generate_fn = train_rl.build_generate_fn(args, args.device)
    captions = [ex["captions"] for ex in RL_TRAIN]
    pred = [([box for _, box in RL_LAYOUTS[c]], [lab for lab, _ in RL_LAYOUTS[c]])
            for c in captions]
    gt = [(center2lefttop(ex["bbox"]), ex["label"]) for ex in RL_TRAIN]
    imgs = generate_fn(captions, pred, seed=0)
    del generate_fn
    torch.cuda.empty_cache()
    gt_imgs = next(iter(RLBatches(RL_TRAIN, fx["imgs"], RL_N)))[1]
    reward = train_rl.build_reward(args, args.device)
    K.reset_launches()
    t0 = time.perf_counter()
    got = reward.components(captions, imgs, gt_imgs, pred, gt)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    f32_launches = K.layer_norm.f32_launches
    with K.plain_route():
        ref = reward.components(captions, imgs, gt_imgs, pred, gt)
    delta = {k: float(np.abs(got[k] - ref[k]).max()) for k in got}
    finite = all(bool(np.isfinite(v).all()) for v in (*got.values(), *ref.values()))
    return {"ok": (finite and f32_launches > 0
                   and all(d <= RL_REWARD_TOL for d in delta.values())),
            "max_abs_delta": delta, "tol": RL_REWARD_TOL,
            "components": {k: v.tolist() for k, v in got.items()},
            "reward_s": kernel_s, "k3_f32_launches": f32_launches,
            "images": list(imgs.shape)}


def phase_rl(work_dir: str):
    """The RL path at full width: the reward check, then cli/train_rl.py
    main for 2 epochs and 1 more resumed from its directory. Fails unless
    the kernel and plain routes' reward components agree, every reward and
    loss is finite, the policy changes each epoch, the reference-format
    files load through the port's loaders and the resumed Adam step count
    continues from the saved one. Launches counted from 0 over the two
    training runs."""
    from layoutllm_t2i_torch import kernels as K
    from layoutllm_t2i_torch.checkpoint.convert import load_policy, load_policy_state
    from layoutllm_t2i_torch.cli import train_rl
    from layoutllm_t2i_torch.models.initializers import Init
    from layoutllm_t2i_torch.models.policy import init_policy_params

    shutil.rmtree(work_dir, ignore_errors=True)
    fx = rl_fixture(work_dir)
    check = reward_check(fx)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    run_dir, history = train_rl.main(rl_argv(fx, "--epochs", str(RL_EPOCHS),
                                             "--exp", "rl"))
    resumed_dir, resumed = train_rl.main(rl_argv(
        fx, "--epochs", str(RL_RESUME_EPOCHS), "--exp", "rl_resume",
        "--resume", run_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    f32_launches = counts["K3/f32"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = []
    for d in (run_dir, resumed_dir):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            metrics += [json.loads(line) for line in f]
    # the policy the trainer starts from (RLConfig's seed 53), then each
    # epoch's checkpoint: every one differs from the one before
    init = init_policy_params(Init(torch.Generator().manual_seed(53),
                                   torch.device("cpu")), 768, 128)["linear"]
    epochs = RL_EPOCHS + RL_RESUME_EPOCHS
    dirs = [run_dir] * RL_EPOCHS + [resumed_dir] * RL_RESUME_EPOCHS
    weights = [init["weight"]] + [
        load_policy(os.path.join(d, f"ckpt_{e}.pt"))["linear"]["weight"]
        for e, d in enumerate(dirs)]
    changed = [not torch.equal(a, b) for a, b in zip(weights, weights[1:])]
    steps = [load_policy_state(os.path.join(d, f"state_{e}.pt"))["step"]
             for e, d in enumerate(dirs)]
    with open(os.path.join(run_dir, "history.json")) as f:
        history_ok = json.load(f) == history
    values = (history["reward_history"] + history["loss_history"]
              + resumed["reward_history"] + resumed["loss_history"])
    ok = (check["ok"] and history_ok and all(changed)
          and len(values) == 2 * epochs and all(math.isfinite(v) for v in values)
          and steps == list(range(1, epochs + 1)) and f32_launches > 0
          and all(counts[kid] > 0 for kid in ("K1", "K2", "K3", "K4")))
    ok = ok and all(counts[f"{kid}/f32"] == 0 for kid in ("K1", "K2", "K4", "K5a",
                                                           "K5b"))
    emit({"phase": "rl", "ok": ok, "card": nvidia_smi_line(),
          "reward_check": check, "wall_s": wall,
          "epochs": epochs, "rollouts_per_epoch": RL_N,
          "epoch_s": [m["batch_s"] for m in metrics],
          "rollout_s": [m["rollout_s"] for m in metrics],
          "reward_s": [m["reward_s"] for m in metrics],
          "rewards": history["reward_history"] + resumed["reward_history"],
          "losses": history["loss_history"] + resumed["loss_history"],
          "policy_changed_each_epoch": changed, "adam_steps": steps,
          "peak_mem_gib": peak, "k3_f32_launches": f32_launches,
          "launches": counts})
    if not ok:
        raise SmokeFailure(
            "rl: the reward's kernel route is off its plain route (or not "
            "through K3's f32 form), a reward or loss is not finite, the "
            "policy did not change in an epoch, a checkpoint is missing or "
            "the resumed Adam step count does not continue, or K1-K4 not "
            "launched")
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts


# phase eval: the COCO-NSS1K runner (eval/nss1k.py) at full width on a
# fixture written to the build directory: the five split files, 2 examples
# each in the reference schema (captions with a relation the scene-graph
# parser finds, centre-xywh boxes, COCO-80 labels, image names)
EVAL_SPLITS = {
    "numerical": [("three dogs standing next to a bench", ["dog", "bench"]),
                  ("two cats sleeping on a couch", ["cat", "couch"])],
    "spatial": [("a bus parked behind a truck", ["bus", "truck"]),
                ("a kite flying over a boat", ["kite", "boat"])],
    "semantic": [("a man riding a horse on the beach", ["person", "horse"]),
                 ("a woman holding an umbrella near a bicycle",
                  ["person", "umbrella"])],
    "mixed": [("a pizza on top of a wooden table", ["pizza", "dining table"]),
              ("a bird sitting on a tree branch above a car", ["bird", "car"])],
    "null": [("a person sitting on a bench", ["person", "bench"]),
             ("a dog chasing a frisbee on the grass", ["dog", "frisbee"])],
}
EVAL_BOXES = [[0.35, 0.55, 0.4, 0.5], [0.7, 0.4, 0.3, 0.35]]
EVAL_N = 2          # examples a split, and the runner's batch
EVAL_FID_SPLIT = "spatial"
# run B's planner: the cached layouts of the FID split's captions, top-left
# xywh, one label ("lorry") outside COCO-80
EVAL_LAYOUTS = {
    "a bus parked behind a truck": [["bus", [0.05, 0.3, 0.5, 0.45]],
                                    ["lorry", [0.5, 0.35, 0.45, 0.4]]],
    "a kite flying over a boat": [["kite", [0.4, 0.05, 0.2, 0.2]],
                                  ["boat", [0.2, 0.55, 0.6, 0.35]]],
}
EVAL_INCEPTION_BATCH = 16
# Inception pool3 features on the card against the same module on the CPU,
# both f32 with TF32 off: ||a - b|| / ||b||. The two differ by summation
# order in ~100 convolutions (cuDNN against the CPU's), ~1e-6 of the norm;
# a TF32 pass (10 mantissa bits) would sit near 1e-3.
EVAL_INCEPTION_REL_TOL = 1e-4
# the kernels every eval run launches: the generation's, and K3's f32 form
# in the reward's CLIP towers (CLIPScore)
EVAL_KIDS = ("K1", "K2", "K3", "K4", "K3/f32")


def eval_requests(split: str, planned: bool = False):
    """The requests run_bench gives pipe.generate for one split at batch 2:
    captions, the GT layouts in ltrb (or, ``planned``, the cached layouts'),
    the relation texts of the scene-graph parser."""
    from layoutllm_t2i_torch.pipeline.inference import (convert_xcycwh_to_ltrb,
                                                        convert_xywh_to_ltrb)
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_inference

    captions = [cap for cap, _ in EVAL_SPLITS[split]]
    if planned:
        layouts = [([convert_xywh_to_ltrb(box) for _, box in EVAL_LAYOUTS[c]],
                    [lab for lab, _ in EVAL_LAYOUTS[c]]) for c in captions]
    else:
        layouts = [([convert_xcycwh_to_ltrb(box) for box in EVAL_BOXES[:len(labels)]],
                    labels) for _, labels in EVAL_SPLITS[split]]
    return captions, layouts, [relation_texts_for_inference(c, 5) or []
                               for c in captions]


def eval_paths(unet_cfg, vae_cfg, clip_cfg, tok_len, text_cfg, vision_cfg) -> list:
    """The calls of phase eval's two runs: run A, each split's fast-preset
    generation at batch 2 and CLIPScore (the reward's f32 text and vision
    towers on 2 captions and 2 images); run B, the planner's text features
    of the candidates and the captions, the open-vocabulary label through
    the text tower, then the exact generation on the planned layouts and
    its CLIPScore. The reward's 80 COCO label embeddings are rl_calls'."""
    fast_evals = unet_evaluations(fast_tables_pipeline(), EVAL_N)
    score = (f32_calls(clip_calls(text_cfg, EVAL_N * tok_len))
             + vision_calls(vision_cfg, EVAL_N))
    calls = []
    for split in EVAL_SPLITS:
        calls += generation_calls(unet_cfg, vae_cfg, clip_cfg, tok_len,
                                  eval_requests(split), VAE_CHUNK,
                                  evals=fast_evals) + score
    calls += f32_calls(clip_calls(text_cfg, len(CLI_CANDIDATES) * tok_len))
    calls += f32_calls(clip_calls(text_cfg, tok_len))
    return calls + generation_calls(
        unet_cfg, vae_cfg, clip_cfg, tok_len,
        eval_requests(EVAL_FID_SPLIT, planned=True), VAE_CHUNK) + score


def eval_fixture(work_dir: str) -> dict:
    """The five NSS1K split files, 512^2 ground-truth PNGs (utils/images.py,
    seeded numpy), the planner's candidate pool and layout cache, and a
    random-init Inception saved under torchvision's names."""
    from layoutllm_t2i_torch.eval.fid import random_inception
    from layoutllm_t2i_torch.eval.nss1k import SPLIT_FILES
    from layoutllm_t2i_torch.utils.images import png_bytes

    data, imgs, cands = (os.path.join(work_dir, d) for d in ("nss1k", "imgs", "cands"))
    for d in (data, imgs, cands):
        os.makedirs(d)
    rng = np.random.default_rng(0)
    for split, items in EVAL_SPLITS.items():
        examples = [{"img_id": i, "name": f"{split}_{i}.png", "width": 512,
                     "height": 512, "captions": cap, "label": labels,
                     "bbox": EVAL_BOXES[:len(labels)]}
                    for i, (cap, labels) in enumerate(items)]
        with open(os.path.join(data, SPLIT_FILES[split]), "w") as f:
            json.dump(examples, f)
        for ex in examples:
            with open(os.path.join(imgs, ex["name"]), "wb") as f:
                f.write(png_bytes(rng.uniform(size=(512, 512, 3))))
    pool = [{"img_id": 10 + i, "name": f"cand_{i}.jpg", "width": 640,
             "height": 480, **c} for i, c in enumerate(CLI_CANDIDATES)]
    for name in ("train2014_train_1.json",
                 f"train2014_candidate_{len(pool)}.json"):
        with open(os.path.join(cands, name), "w") as f:
            json.dump({"id": [c["img_id"] for c in pool], "data": pool}, f)
    cache = os.path.join(work_dir, "layouts.json")
    with open(cache, "w") as f:
        json.dump(EVAL_LAYOUTS, f)
    inception = os.path.join(work_dir, "pt_inception.pth")
    torch.save(random_inception("cpu", seed=0).state_dict(), inception)
    return {"data": data, "imgs": imgs, "cands": cands, "cache": cache,
            "inception": inception, "n_cands": len(pool),
            "fid_split": os.path.join(data, SPLIT_FILES[EVAL_FID_SPLIT])}


def counted(fn):
    """(fn(), its wall s, the kernel launches it made), counts from 0."""
    from layoutllm_t2i_torch.kernels import reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, path_counts()


def inception_check(fx: dict) -> dict:
    """The Inception of run B's checkpoint: features of 2 ground-truth
    images on the card against the same module on the CPU (relative L2),
    and the card's ms per image at batch 16 (pool3 on 299^2 inputs, f32,
    TF32 off; CUDA events around back-to-back calls)."""
    from layoutllm_t2i_torch.eval.fid import (INCEPTION_SIZE, inception_features,
                                              inception_pool3,
                                              load_inception_checkpoint)
    from layoutllm_t2i_torch.eval.nss1k import load_gt_images, load_split

    examples = load_split(fx["fid_split"])
    imgs = load_gt_images(examples, fx["imgs"])
    on_card = load_inception_checkpoint(fx["inception"], device="cuda")
    got = inception_features(on_card, imgs, batch=len(imgs))
    ref = inception_features(load_inception_checkpoint(fx["inception"],
                                                       device="cpu"),
                             imgs, batch=len(imgs))
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    x = torch.rand((EVAL_INCEPTION_BATCH, INCEPTION_SIZE, INCEPTION_SIZE, 3),
                   generator=torch.Generator(device="cuda").manual_seed(0),
                   device="cuda") * 2 - 1
    ms = time_ms(lambda: inception_pool3(on_card, x), target_ms=200.0)
    return {"ok": bool(np.isfinite(got).all()) and rel <= EVAL_INCEPTION_REL_TOL,
            "features_rel_l2_vs_cpu": rel, "tol": EVAL_INCEPTION_REL_TOL,
            "features": list(got.shape), "batch": EVAL_INCEPTION_BATCH,
            "ms_per_batch": ms, "ms_per_image": ms / EVAL_INCEPTION_BATCH}


def phase_eval(work_dir: str):
    """eval/nss1k.py main in this process, at full width on the card
    (random weights from seed 0: the UNet in bf16, the reward's CLIP
    ViT-L/14 text and vision towers in f32, InceptionV3 at 299^2 in f32).
    Run A: the five splits under --fast, batch 2: five rows of n 2, an
    overall row of n 10, every clip_score_mean finite and in [0, 2.5]. Run
    B: the FID split at exact PLMS-50 with the offline planner and FID:
    layout mIoU and DocSim in [0, 1], both layouts parsed, FID finite. Then
    the Inception on the card against the CPU. Each run's launches are
    counted from 0 and must include K1-K4 and K3's f32 form."""
    from layoutllm_t2i_torch.eval import nss1k

    shutil.rmtree(work_dir, ignore_errors=True)
    fx = eval_fixture(work_dir)
    run_a, wall_a, counts_a = counted(lambda: nss1k.main(
        ["--data_dir", fx["data"], "--batch_size", str(EVAL_N), "--fast"]))
    torch.cuda.empty_cache()
    run_b, wall_b, counts_b = counted(lambda: nss1k.main(
        ["--data_path", fx["fid_split"], "--batch_size", str(EVAL_N),
         "--layout", "planner", "--layout_cache", fx["cache"],
         "--cand_data_dir", fx["cands"], "--cand_number", str(fx["n_cands"]),
         "--fid", "--img_dir", fx["imgs"], "--inception_ckpt", fx["inception"]]))
    torch.cuda.empty_cache()
    inception = inception_check(fx)
    splits = [k for k in run_a if k != "overall"]
    a_ok = (sorted(splits) == sorted(EVAL_SPLITS)
            and all(run_a[k]["n"] == EVAL_N for k in splits)
            and run_a["overall"]["n"] == EVAL_N * len(EVAL_SPLITS)
            and all(math.isfinite(r["clip_score_mean"])
                    and 0.0 <= r["clip_score_mean"] <= 2.5
                    for r in run_a.values()))
    b_ok = (run_b["n"] == EVAL_N and run_b["layout_parsed"] == EVAL_N
            and all(0.0 <= run_b[k] <= 1.0 for k in ("layout_miou", "layout_docsim"))
            and math.isfinite(run_b["clip_score_mean"])
            and math.isfinite(run_b["fid"]))
    launched = all(c[kid] > 0 for c in (counts_a, counts_b) for kid in EVAL_KIDS)
    ok = a_ok and b_ok and inception["ok"] and launched
    counts = {kid: counts_a[kid] + counts_b[kid] for kid in counts_a}
    emit({"phase": "eval", "ok": ok, "card": nvidia_smi_line(),
          "run_a": {"argv": "--data_dir --fast --batch_size 2", "ok": a_ok,
                    "wall_s": wall_a, "result": run_a,
                    "sec_per_image": run_a["overall"]["sec_per_image"],
                    "launches": counts_a},
          "run_b": {"argv": "--data_path --layout planner --fid --batch_size 2",
                    "ok": b_ok, "wall_s": wall_b, "result": run_b,
                    "sec_per_image": run_b["sec_per_image"],
                    "launches": counts_b},
          "inception": inception, "launches": counts})
    if not ok:
        raise SmokeFailure(
            "eval: a split row or the overall row is off its count, a "
            "CLIPScore is outside [0, 2.5] or not finite, a layout metric is "
            "outside [0, 1], a layout was not parsed, the FID is not finite, "
            "the card's Inception features are off the CPU's, or K1-K4 or "
            "K3/f32 launched no time in a run")
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts


def profile_generation(models, label: str, profile, suffix: str) -> None:
    """With ``--profile``, one more generation of ``models`` (on the route
    the switches set) under the profiler, into the profile's path, with
    ``suffix`` in place of its extension if given."""
    if profile:
        pipe = exact_pipeline(models)
        path = os.path.splitext(profile)[0] + suffix if suffix else profile
        profile_device(lambda: pipe.generate(*REQUESTS, seed=0), label, path,
                       steps=STEPS)


def phase_int8(models, dense_img, profile=None, label="int8"):
    """The int8 UNet of phase 4's bundle (phase int8-f32: of phase
    generate-f32's f32 bundle, K7's f32 form): its bytes, K7 in a UNet
    forward against the plain route and against the default int8 route,
    and the generation (launches; images against the dense bundle's from
    the same noise; in f32, K7/f32's launches against the walk's)."""
    from layoutllm_t2i_torch.ops.quant import quantized_bytes
    from layoutllm_t2i_torch.pipeline.loaders import quantize_unet_int8

    f32 = models.compute_dtype is torch.float32
    form = "/f32" if f32 else ""
    qmodels = quantize_unet_int8(models)
    dense_b = quantized_bytes(models.unet_params)
    int8_b = quantized_bytes(qmodels.unet_params)
    run = unet_runner(qmodels)
    with route_env(INT8):
        out, ref, fwd_counts, plain_launched = routed_unet(run)
    with route_env(INT8_DEQUANT):
        dequant = run()
    vs_plain, vs_dequant = unet_agreement(out, ref), unet_agreement(out, dequant)
    del out, ref, dequant
    with route_env(INT8):
        rec, counts, img = run_generation(qmodels, label)
        profile_generation(qmodels, f"profile-{label}", profile, f"_{label}.json")
    img_diff = float(np.abs(img - dense_img).mean())
    walk_ok = True
    if f32:
        walk = generation_walk(qmodels, INT8)
        rec["walked_launches"] = walk
        walk_ok = counts["K7/f32"] == walk["K7/f32"] > 0
    ok = (vs_plain["ok"] and vs_dequant["ok"] and not plain_launched
          and fwd_counts["K7" + form] > 0 and fwd_counts["K4" + form] == 0
          and rec["ok"] and img_diff < INT8_IMAGE_TOL and walk_ok
          and (f32 or int8_b / dense_b <= INT8_BYTES_RATIO_MAX))
    rec.update({"ok": ok, "unet_dense_bytes": dense_b, "unet_int8_bytes": int8_b,
                "bytes_ratio": int8_b / dense_b,
                "bytes_ratio_max": INT8_BYTES_RATIO_MAX,
                "unet_vs_plain": vs_plain, "unet_vs_dequant_route": vs_dequant,
                "unet_tol_rel": UNET_REL_TOL, "unet_launches": fwd_counts,
                "plain_route_launched": plain_launched,
                "image_mean_abs_diff_vs_dense": img_diff,
                "image_tol": INT8_IMAGE_TOL})
    emit(rec)
    if not ok:
        raise SmokeFailure(f"{label}: K7 disagrees with the plain or the "
                           "dequant route, the generation is off, K7's "
                           "launches are not the walk's, or the bytes or "
                           "image bounds fail")
    return counts


def generation_walk(models, route) -> dict:
    """{row id: launches} of run_generation's timed generation of
    ``models`` on ``route``: every call of PLMS-50 on REQUESTS, walked from
    the configs and the exact pipeline's step tables (every UNet
    evaluation, not each distinct one)."""
    pipe = exact_pipeline(models)
    return launches_of(generation_calls(
        models.unet_cfg, models.vae_cfg, models.clip_cfg,
        models.clip_cfg.max_length, REQUESTS, VAE_CHUNK, route=route,
        evals=unet_evaluations(pipe, len(REQUESTS[0])),
        f32=models.compute_dtype is torch.float32, distinct=False))


def phase_generate_f32(bf16_img):
    """random_models(dtype=torch.float32) at full width: phase 4's
    generation (requests, seed, alpha, PLMS-50, CFG 7.5) through the f32
    forms of K1-K4, every launch against the walk's, and each image's PSNR
    against phase 4's bf16 image from the same noise (printed, not held to
    a bound: bf16 rounding through 50 steps is a different trajectory).
    Returns (launch counts, the f32 bundle, its images)."""
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    models = random_models(small=False, device="cuda", dtype=torch.float32,
                           seed=0)
    rec, counts, img = run_generation(models, "generate-f32")
    walk = generation_walk(models, DEFAULT)
    walk_ok = ({kid: n for kid, n in counts.items() if n} == walk
               and all(kid.endswith("/f32") for kid in walk))
    rec.update({"ok": rec["ok"] and walk_ok, "walked_launches": walk,
                "launches_match_walk": walk_ok,
                "psnr_vs_bf16_db": [psnr_db(a, b) for a, b in zip(img, bf16_img)]})
    emit(rec)
    if not rec["ok"]:
        raise SmokeFailure("generate-f32: the images are not a finite "
                           "(2,512,512,3) batch in [0, 1], or the launches "
                           "are not the walk's")
    return counts, models, img


def phase_routes_f32(work_dir: str, profile=None):
    """The split FF routes (LLT2I_FFN_LN=0, LLT2I_PALLAS_MATMUL=1) in f32:
    a full-width f32 UNet forward (alphas 0.5) against the plain route;
    phase train-grad-f32 under the route (K6/f32, K8a/f32 and K8b/f32 in
    the gradients, none on the plain route); then phase train-f32 under
    the route, one warm-up and two timed steps, every launch of K1, K5a,
    K5b, K6, K8a and K8b a step the walk's; with ``profile``, one more
    step under the profiler. Returns the training's launch counts."""
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    with route_env(SPLIT):
        models = random_models(small=False, device="cuda", dtype=torch.float32,
                               seed=0)
        n_alpha = set_alphas(models.unet_params, 0.5)
        out, ref, fwd_counts, plain_launched = routed_unet(unet_runner(models))
        agree = unet_agreement(out, ref)
        del out, ref, models
        torch.cuda.empty_cache()
        split = ("K6/f32", "K8a/f32", "K8b/f32")
        ok = (agree["ok"] and not plain_launched and fwd_counts["K4/f32"] == 0
              and all(fwd_counts[kid] > 0 for kid in split)
              and not any(fwd_counts[kid.split("/")[0]] for kid in split))
        emit({"phase": "routes-f32", "ok": ok, "alphas_set": n_alpha,
              "env": SPLIT.env(), "unet_vs_plain": agree,
              "unet_tol_rel": UNET_REL_TOL, "unet_launches": fwd_counts,
              "plain_route_launched": plain_launched})
        if not ok:
            raise SmokeFailure("routes-f32: the split FF routes in f32 "
                               "disagree with the plain route, or K6/f32, "
                               "K8a/f32 and K8b/f32 did not all launch")
        phase_train_grad(mixed_precision=False, route=SPLIT,
                         label="routes-f32-grad")
        counts, trainer, data = phase_train(work_dir, mixed_precision=False,
                                            route=SPLIT, steps=ROUTES_F32_STEPS,
                                            warmup=ROUTES_F32_WARMUP,
                                            label="routes-f32-train")
        if profile:
            profile_train_step(trainer, data, "routes-f32", profile)
        trainer.close()
    del trainer, data
    torch.cuda.empty_cache()
    return counts


def phase_routes(models, profile=None):
    """LLT2I_FFN_LN=0 + LLT2I_PALLAS_MATMUL=1: K6 at the norm3 sites, K8b and
    K8a at the fusers' dense branch; a UNet forward against the plain
    route, then the generation."""
    with route_env(SPLIT):
        out, ref, fwd_counts, plain_launched = routed_unet(unet_runner(models))
        agree = unet_agreement(out, ref)
        del out, ref
        rec, counts, _ = run_generation(models, "routes", env=SPLIT.env())
        profile_generation(models, "profile-routes", profile, "_routes.json")
    ok = (agree["ok"] and not plain_launched and rec["ok"]
          and fwd_counts["K4"] == 0
          and all(fwd_counts[kid] > 0 for kid in ("K6", "K8a", "K8b")))
    rec.update({"ok": ok, "unet_vs_plain": agree, "unet_tol_rel": UNET_REL_TOL,
                "unet_launches": fwd_counts,
                "plain_route_launched": plain_launched})
    emit(rec)
    if not ok:
        raise SmokeFailure("routes: the split FF routes disagree with the "
                           "plain route, or the generation is off")
    return counts


def synthetic_step_batch(cfg, b: int, dev, gen) -> dict:
    """A full-width training batch of the shapes prepare_batch gives: clean
    latents, CLIP-width context, three boxes with phrases, two relations."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    boxes = torch.zeros(b, 30, 4, device=dev)
    boxes[:, :3] = torch.tensor([[0.1, 0.2, 0.5, 0.9], [0.55, 0.1, 0.95, 0.6],
                                 [0.3, 0.5, 0.7, 0.95]], device=dev)
    masks = torch.zeros(b, 30, device=dev)
    masks[:, :3] = 1
    rel = torch.zeros(b, 10, cfg.context_dim, device=dev)
    rel[:, :2] = rnd(b, 2, cfg.context_dim) * 0.5
    z = rnd(b, 4, cfg.image_size, cfg.image_size).contiguous(
        memory_format=torch.channels_last)
    return {"z": z, "context": rnd(b, 77, cfg.context_dim) * 0.5,
            "boxes": boxes, "masks": masks,
            "phrase_embeddings": rnd(b, 30, cfg.grounding_in_dim) * 0.5,
            "relations": rel}


@contextlib.contextmanager
def planted_fault(name: str):
    """Plant fault ``name`` in the K5 wrappers that FlashAttention.backward
    calls; the kernels still launch (and count) as on the kernel route."""
    # the module, not the function the package exports under its name
    fa = importlib.import_module("layoutllm_t2i_torch.kernels.flash_attention")
    dq_fn, dkv_fn = fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv

    # each call fills a workspace of its own (the planted operands of
    # dq_kv_tail are not the ones the pair's shared pre-pass would split)
    def dq(q, k, v, dout, lse, delta, heads, scale, **_):
        if name == "softmax_scale":
            return dq_fn(q, k, v, dout, lse, delta, heads, scale * 1.005)
        if name == "dq_kv_tail":
            m = k.shape[1] - k.shape[1] % 64
            return dq_fn(q, k[:, :m], v[:, :m], dout, lse, delta, heads, scale)
        out = dq_fn(q, k, v, dout, lse, delta, heads, scale)
        return out * 1.01 if name == "dq_1pct" else out

    def dkv(q, k, v, dout, lse, delta, heads, scale, **_):
        if name == "softmax_scale":
            return dkv_fn(q, k, v, dout, lse, delta, heads, scale * 1.005)
        dk, dv = dkv_fn(q, k, v, dout, lse, delta, heads, scale)
        return (dk / scale if name == "dk_unscaled" else dk), dv

    # the wrappers count through their module's names: these get the counts
    dq.launches = dkv.launches = dq.f32_launches = dkv.f32_launches = 0
    fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = dq, dkv
    try:
        yield
    finally:
        fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = dq_fn, dkv_fn


def rel_l2(grads, ref) -> float:
    """||g - g_ref|| / ||g_ref|| over all tensors together."""
    num = sum(float((a - b).double().pow(2).sum()) for a, b in zip(grads, ref))
    den = sum(float(b.double().pow(2).sum()) for b in ref)
    return math.sqrt(num / den)


def step_kernels(route: Route) -> tuple:
    """The kernels a training step launches on ``route``: K1-K3, K5a/K5b
    and the FF sites' (K4, or K6, K8a and K8b on the split routes)."""
    ff = ("K6", "K8a", "K8b") if route == SPLIT else ("K4",)
    return ("K1", "K2", "K3", "K5a", "K5b") + ff


def grad_walk(unet_cfg, mixed_precision: bool = True, route: Route = DEFAULT):
    """phase_train_grad's walk: one training UNet forward at batch 2, 30
    grounding tokens, 10 relations and 77 context tokens (f32 calls when
    not ``mixed_precision``)."""
    walk = unet_calls(unet_cfg, 2, 30, 10, 77, train=True, route=route,
                      itemsize=2 if mixed_precision else 4)
    return walk if mixed_precision else f32_calls(walk)


# the gradient checks' geometries whose K5 runs past d 160, and the head
# dim past which phase kernels holds their sites: num_heads 1's past 320
# alone (its d 320 sites, N = 4096 at 512^2 and 9216 at 768^2, would add
# the most time and test no kernel that heads2's do not)
WIDE_K5_GEOMETRIES = {"heads2": 160, "hires5": 160, "heads1": 320,
                      "hires1": 320}


def wide_k5_sites(unet_cfg, geometry: str, mixed_precision: bool = True):
    """The K1 calls with their lse past WIDE_K5_GEOMETRIES[geometry] of
    phase_train_grad's walk at ``geometry`` (each is also a K5a and a K5b
    case): num_heads 2's 32^2 sites (d 320, N = M = 1024 and 1054),
    num_heads 5's 24^2 sites at 768^2 (d 256, 576 and 606), num_heads 1's
    32^2 sites (d 640, 1024 and 1054) or its 48^2 and 24^2 sites at 768^2
    (d 640, 2304 and 2334; d 1280, 576 and 606), as the walk makes them."""
    cfg = dataclasses.replace(unet_cfg, **GEOMETRY[geometry])
    past = WIDE_K5_GEOMETRIES[geometry]
    return [(kid, args) for kid, args in grad_walk(cfg, mixed_precision)
            if kid == "K1" and has_lse(args) and args[4] > past]


def phase_train_grad(mixed_precision: bool = True, route: Route = DEFAULT,
                     label: str = "", geometry: str = ""):
    """One full-width loss backward at batch 2 through the kernels and
    again through the plain versions, from the same weights and draws, on
    ``route`` (under its switches); then, on the default route, once with
    each planted K5 fault. ``mixed_precision`` False: phase train-grad-f32,
    every operand f32 (the kernels' f32 forms), held to
    TRAIN_GRAD_F32_REL_TOL. ``geometry``: a GEOMETRY name (phase
    train-hires: 96^2 latents, or num_heads 5), where the planted fault is
    TRAIN_GRAD_CAUGHT's alone and K5's launches at GEOMETRY_K5_DIMS must
    be the walk's site by site (unet_calls at batch 2 with the lse).
    Returns the kernel route's launch counts."""
    from layoutllm_t2i_torch.kernels import plain_route, reset_launches
    from layoutllm_t2i_torch.pipeline.loaders import random_models
    from layoutllm_t2i_torch.training.train_step import TrainStep, TrainStepConfig

    label = label or ("train-grad" if mixed_precision else "train-grad-f32")
    tol = TRAIN_GRAD_REL_TOL if mixed_precision else TRAIN_GRAD_F32_REL_TOL
    dev = torch.device("cuda")
    models = (geometry_models(geometry, torch.float32) if geometry else
              random_models(small=False, device=dev, dtype=torch.float32, seed=0))
    n_alpha = set_alphas(models.unet_params, 0.5)
    step = TrainStep(TrainStepConfig(unet_cfg=models.unet_cfg,
                                     schedule=models.schedule,
                                     mixed_precision=mixed_precision,
                                     warmup_steps=0),
                     models.unet_params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batch = synthetic_step_batch(models.unet_cfg, 2, dev, gen)
    t = torch.tensor([801, 301], device=dev)
    noise = torch.randn(batch["z"].shape, generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    keep = torch.ones((), device=dev)
    grads = lambda: step.grads(batch, t, noise, keep)
    reset_launches()
    with recorded_calls() as calls:
        loss_k, g_k = grads()
        torch.cuda.synchronize()
    counts = path_counts()
    with plain_route():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    plain_launched = path_counts() != counts
    rel = rel_l2(g_k, g_p)
    per_tensor = {name: float((a - b).norm() / max(float(b.norm()), 1e-30))
                  for name, a, b in zip(step.params, g_k, g_p)}
    worst = max(per_tensor, key=per_tensor.get)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    del g_k
    faults = {}
    planted = () if route != DEFAULT else (
        TRAIN_GRAD_CAUGHT if geometry else TRAIN_GRAD_CAUGHT + TRAIN_GRAD_UNSEEN)
    for name in planted:
        with planted_fault(name):
            g_f = grads()[1]
        faults[name] = rel_l2(g_f, g_p)
        del g_f
    # the step's kernels in its precision, f32 forms or bf16
    launched = all(counts[kid if mixed_precision else f"{kid}/f32"] > 0
                   for kid in step_kernels(route))
    k5 = {}
    if geometry:
        # K5's sites by head dim: the K1 sites with their lse, recorded and
        # walked, and its launches in all those of the walk
        cfg = models.unet_cfg
        walk = grad_walk(cfg, mixed_precision, route)
        sites = sites_by_dim(calls, "K5a", GEOMETRY_K5_DIMS[geometry])
        walked = launches_of(walk)
        tag = "" if mixed_precision else "/f32"
        k5 = {"k5_sites": {f"d{d} N{n} M{m}": c for (d, n, m), c in sorted(sites.items())},
              "k5_walked": {kid: walked.get(f"{kid}{tag}", 0) for kid in ("K5a", "K5b")}}
        k5["k5_match_walk"] = (
            sites == sites_by_dim(walk, "K5a", GEOMETRY_K5_DIMS[geometry])
            and {d for d, _, _ in sites} == set(GEOMETRY_K5_DIMS[geometry])
            and all(counts[f"{kid}{tag}"] == n for kid, n in k5["k5_walked"].items()))
        launched = launched and k5["k5_match_walk"]
    ok = (finite and not plain_launched and rel <= tol and launched
          and all(faults[name] > tol for name in faults
                  if name in TRAIN_GRAD_CAUGHT))
    emit({"phase": label, "ok": ok, "batch": 2, "alphas_set": n_alpha,
          **({"geometry": GEOMETRY[geometry], "card": nvidia_smi_line(), **k5}
             if geometry else {}),
          "mixed_precision": mixed_precision, "route": route.env(),
          "trainable_tensors": len(g_p),
          "trainable_params": sum(g.numel() for g in g_p),
          "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
          "grad_rel_l2_err": rel, "tol_rel_l2": tol,
          "planted_fault_rel_l2_err": faults,
          "worst_tensor": worst, "worst_tensor_rel_l2_err": per_tensor[worst],
          "worst_tensor_grad_norm": float(g_p[list(step.params).index(worst)].norm()),
          "grad_norm": math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_p)),
          "launches": counts})
    if not ok:
        raise SmokeFailure(f"{label}: the kernel route lies outside the "
                           "bound, a planted fault it must catch inside it, "
                           "a kernel of the step did not launch (or K5 other "
                           "than the walk's), or a plain-route call launched "
                           "a kernel")
    del models, step, g_p
    torch.cuda.empty_cache()
    return counts


TRAIN_STEPS, TRAIN_WARMUP = 7, 2
# phase routes-f32's training: one warm-up step and two timed ones
ROUTES_F32_STEPS, ROUTES_F32_WARMUP = 3, 1


def phase_train(work_dir: str, mixed_precision: bool = True,
                route: Route = DEFAULT, steps: int = TRAIN_STEPS,
                warmup: int = TRAIN_WARMUP, label: str = ""):
    """DiffusionTrainer at full width, ``steps`` steps of which the first
    ``warmup`` are not timed, on ``route`` (under its switches); returns
    (launch counts, trainer, data iterator). ``mixed_precision`` False:
    phase train-f32, TrainerConfig()'s own precision (f32 throughout, the
    JAX package's default)."""
    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.kernels import reset_launches
    from layoutllm_t2i_torch.pipeline.loaders import random_models
    from layoutllm_t2i_torch.training.diffusion_trainer import (
        DiffusionTrainer, TrainerConfig)

    label = label or ("train" if mixed_precision else "train-f32")
    shutil.rmtree(work_dir, ignore_errors=True)  # no auto-resume from a past run
    # mixed_precision False is TrainerConfig()'s default
    cfg = TrainerConfig(output_root=work_dir, name="chip_smoke",
                        batch_size=TRAIN_BATCH, total_iters=steps,
                        save_every_iters=10 ** 9, log_every=1,
                        warmup_steps=0, trainable_mode="rela_fuse",
                        optimizer="adamw", mixed_precision=mixed_precision,
                        max_boxes=TRAIN_MAX_BOXES,
                        max_relations=TRAIN_MAX_RELATIONS,
                        preview_steps=PREVIEW_STEPS)
    models = random_models(small=False, device="cuda", dtype=torch.float32,
                           seed=0)
    n_alpha = set_alphas(models.unet_params, 0.5)
    data = synthetic_layout_batches(cfg.batch_size, 512, cfg.max_boxes)
    trainer = DiffusionTrainer(cfg, data, models=models)
    before = {n: p.detach().clone()
              for n, p in trainer.models.unet_params.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    trained = trainer.train_step.params
    changed = sum(not torch.equal(p, before[n]) for n, p in trained.items())
    frozen_same = all(torch.equal(p, before[n]) for n, p in
                      trainer.models.unet_params.named_parameters()
                      if n not in trained)
    del before
    with open(f"{trainer.run_dir}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs]
    timed = [r["sec_per_iter"] for r in recs[warmup:]]
    s_step = sum(timed) / len(timed)
    # the launches of one step, walked from the configs (the data's shape
    # is the same every step): prepare_batch's encoders in f32 (K1 at
    # d 512 in the VAE), the UNet in the step's precision on the route
    m = trainer.models
    per_step = launches_of(training_calls(
        m.unet_cfg, m.vae_cfg, m.clip_cfg, m.clip_cfg.max_length,
        next(synthetic_layout_batches(cfg.batch_size, 512, cfg.max_boxes)),
        cfg.max_boxes, cfg.max_relations, f32=not mixed_precision,
        route=route))
    walked = ("K1", "K5a", "K5b", "K6", "K8a", "K8b")
    walk_ok = all(counts[kid] == n * steps for kid, n in per_step.items()
                  if kid.split("/")[0] in walked)
    ok = (len(losses) == steps and all(math.isfinite(x) for x in losses)
          and changed == len(trained) and frozen_same and walk_ok
          and all(counts[kid] > 0 for kid in per_step))
    emit({"phase": label, "ok": ok, "batch": TRAIN_BATCH, "steps": steps,
          "mixed_precision": mixed_precision, "route": route.env(),
          "warmup_steps": warmup, "alphas_set": n_alpha,
          "s_per_step": s_step, "s_per_step_each": timed,
          "images_per_s": TRAIN_BATCH / s_step,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "wall_s": wall, "losses": losses,
          "trainable_tensors": len(trained),
          "trainable_params": sum(p.numel() for p in trained.values()),
          "trainable_changed": changed, "frozen_bit_identical": frozen_same,
          "launches": counts,
          "launches_per_step": {k: v / steps for k, v in counts.items()},
          "walked_per_step": per_step,
          "launches_match_walk": walk_ok})
    if not ok:
        raise SmokeFailure(f"{label}: a loss is not finite, a rela_fuse "
                           "tensor did not change or a frozen one did, or a "
                           "kernel of the walk launched no time or other "
                           "than the walk's count")
    return counts, trainer, data


# phase train's preview: the trainer's PLMS sample grid at 10 steps, a depth
# cut of the reference's 50 (TrainerConfig.preview_steps), on the next batch
PREVIEW_STEPS = 10
# the kernels a mixed-precision preview launches: the bf16 UNet and VAE
# decode, and K3's f32 form in the trainer's f32 text encoder
PREVIEW_KIDS = ("K1", "K2", "K3", "K4", "K3/f32")


def preview_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, batch) -> list:
    """trainer.sample_previews on a host batch under mixed precision: the
    captions and as many empty prompts through the trainer's f32 text
    encoder, the grounding texts as a training step encodes them (f32), the
    bf16 UNet at CFG batch 2b, the bf16 VAE decode of the b latents in one
    chunk."""
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_training
    from layoutllm_t2i_torch.utils.buckets import pow2_bucket

    b = len(batch["caption"])
    n_texts = (sum(min(len(labels), TRAIN_MAX_BOXES) for labels in batch["labels"])
               + sum(len(relation_texts_for_training(c, TRAIN_MAX_RELATIONS))
                     for c in batch["caption"]))
    calls = 2 * clip_calls(clip_cfg, pow2_bucket(b) * tok_len)
    if n_texts:
        calls += clip_calls(clip_cfg, pow2_bucket(n_texts) * tok_len)
    return (f32_calls(calls)
            + unet_calls(unet_cfg, 2 * b, TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS,
                         tok_len)
            + vae_decoder_calls(vae_cfg, b, unet_cfg.image_size))


def phase_train_preview(trainer, data) -> dict:
    """trainer.sample_previews on the next batch after phase train's timed
    steps (its s/step is read before): both PNGs written, each a grid of
    512^2 tiles (white 2-pixel gutters), the samples not constant; every
    trainable rela_fuse tensor bit-identical before and after (a preview
    changes no weight); launches counted from 0 over the preview."""
    from layoutllm_t2i_torch.utils.images import read_png

    trained = trainer.train_step.params
    before = {n: p.detach().clone() for n, p in trained.items()}
    it = trainer.train_step.step
    _, wall, counts = counted(lambda: trainer.sample_previews(next(data), it))
    unchanged = all(torch.equal(p, before[n]) for n, p in trained.items())
    del before
    ncols = min(4, TRAIN_BATCH)
    rows = -(-TRAIN_BATCH // ncols)
    want = (rows * 514 - 2, ncols * 514 - 2, 3)
    grids = {}
    for kind in ("samples", "real"):
        with open(os.path.join(trainer.run_dir, f"{kind}_{it:08d}.png"), "rb") as f:
            grids[kind] = read_png(f.read())
    tiles_ok = all(g.shape == want and (g[512:514] == 255).all()
                   and (g[:, 512:514] == 255).all() for g in grids.values())
    varied = float(grids["samples"][:512, :512].std()) > 0.0
    launched = all(counts[kid] > 0 for kid in PREVIEW_KIDS)
    ok = unchanged and tiles_ok and varied and launched
    emit({"phase": "train-preview", "ok": ok, "card": nvidia_smi_line(),
          "preview_steps": PREVIEW_STEPS, "batch": TRAIN_BATCH,
          "cfg_batch": 2 * TRAIN_BATCH, "wall_s": wall,
          "grid": list(want), "grids_ok": tiles_ok, "samples_varied": varied,
          "rela_fuse_bit_identical": unchanged,
          "compute_dtype": str(trainer._preview_pipe.models.compute_dtype),
          "launches": counts})
    if not ok:
        raise SmokeFailure(
            "train-preview: a PNG is missing or not a grid of 512^2 tiles, "
            "the samples are constant, the preview changed a rela_fuse "
            "tensor, or K1-K4 or K3/f32 launched no time")
    return counts


# phase data: one dataset of each kind through the catalog at the training
# size, on fixtures written with utils/images.py from numpy seed 0: source
# images of COCO's shapes and others, all resized with Pillow's bicubic
# filter in numpy (utils/resample.py); the TSV's rows count twice an epoch
DATA_SIZE = 512
DATA_SIZES = ((640, 480), (480, 640), (333, 500), (300, 200), (512, 512),
              (700, 300))
DATA_NAMES = ("VGGrounding", "DIODENormal", "COCOKeypoint")
DATA_REPEATS = (2, 1, 1)
DATA_EPOCHS = 2


def data_fixture(root: str, sizes=DATA_SIZES) -> dict:
    """Under ``root``, where data/catalog.py looks for them: VGGrounding's
    TSV (base64 PNGs at ``sizes``, 0-3 entities a row with boxes and
    768-wide text and image embeddings), DIODENormal's image and map
    directories (maps at other sizes; the last image has no map), and
    COCOKeypoint's images with their person_keypoints and captions JSON (1-2
    persons an image, invisible points and points outside the crop, one
    caption an image)."""
    from layoutllm_t2i_torch.utils.images import png_bytes_uint8, save_png

    rng = np.random.default_rng(0)
    pixels = lambda w, h: rng.integers(0, 256, (h, w, 3), np.uint8)
    j = lambda *p: os.path.join(root, *p)
    tsv = j("GROUNDING", "gqa", "tsv", "train-00.tsv")
    rows = []
    for i, (w, h) in enumerate(sizes):
        ents = []
        for _ in range(int(rng.integers(0, 4))):
            x0, y0 = rng.uniform(0, 0.5, 2)
            ents.append({"box": [float(x0), float(y0), float(x0 + 0.4),
                                 float(y0 + 0.3)],
                         "text_embedding": rng.normal(size=768).tolist(),
                         "image_embedding": rng.normal(size=768).tolist()})
        b64 = base64.b64encode(png_bytes_uint8(pixels(w, h))).decode()
        rows.append(f"id{i}\t{json.dumps({'caption': f'row {i}', 'entities': ents})}"
                    f"\t{b64}\n")
    os.makedirs(os.path.dirname(tsv))
    with open(tsv, "w") as f:
        f.writelines(rows)
    for sub in ("images", "normal"):
        os.makedirs(j("DIODE", sub))
    for i, (w, h) in enumerate(sizes):
        save_png(pixels(w, h), j("DIODE", "images", f"m{i}.png"))
        if i < len(sizes) - 1:
            save_png(pixels(h, w), j("DIODE", "normal", f"m{i}.png"))
    os.makedirs(j("COCO", "images"))
    os.makedirs(j("COCO", "annotations"))
    kp = {"images": [], "annotations": []}
    caps = {"annotations": []}
    for i, (w, h) in enumerate(sizes):
        save_png(pixels(w, h), j("COCO", "images", f"k{i}.png"))
        kp["images"].append({"id": i, "file_name": f"k{i}.png", "width": w,
                             "height": h})
        for _ in range(1 + i % 2):
            pts = np.stack([rng.uniform(-0.1 * w, 1.1 * w, 17),
                            rng.uniform(0, h, 17), rng.integers(0, 3, 17)], 1)
            kp["annotations"].append({
                "image_id": i, "num_keypoints": int((pts[:, 2] > 0).sum()),
                "keypoints": [float(v) for v in pts.reshape(-1)]})
        caps["annotations"].append({"image_id": i, "caption": f"people {i}"})
    for name, obj in (("person_keypoints_train2017.json", kp),
                      ("captions_train2017.json", caps)):
        with open(j("COCO", "annotations", name), "w") as f:
            json.dump(obj, f)
    return {"root": root, "tsv": tsv, "rows": len(sizes)}


def data_item_checks(item: dict, size: int) -> dict:
    """Shape, dtype and range checks of one item of any kind: images
    (size, size, 3) float32 in [-1, 1], maps in [0, 1], boxes and
    keypoints in [0, 1] where masked."""
    ok = {"image": (item["image"].shape == (size, size, 3)
                    and item["image"].dtype == np.float32
                    and -1 <= item["image"].min() and item["image"].max() <= 1)}
    if "condition" in item:
        c = item["condition"]
        ok["condition"] = (c.shape == (size, size, 3)
                           and 0 <= c.min() and c.max() <= 1)
    for key in ("boxes", "points"):
        if key in item:
            on = item[key][item["masks"] > 0]
            ok[key] = bool(((on >= 0) & (on <= 1)).all())
    for key in ("text_embeddings", "image_embeddings"):
        if key in item:
            ok[key] = item[key].shape == (item["masks"].shape[0], 768)
    return ok


def tsv_round_trip(fx: dict, work_dir: str) -> dict:
    """The .lineidx of the TSV's first read gives every row back, and
    tsv_split into 4 shards then tsv_merge gives the TSV and its .lineidx
    back byte for byte."""
    from layoutllm_t2i_torch.data.tsv import TSVFile, tsv_merge, tsv_split

    rows = TSVFile(fx["tsv"])
    ids_ok = [rows[i][0] for i in range(len(rows))] == [
        f"id{i}" for i in range(fx["rows"])]
    merged = tsv_merge(tsv_split(fx["tsv"], 4, os.path.join(work_dir, "shards")),
                       os.path.join(work_dir, "merged.tsv"))
    read = lambda p: open(p, "rb").read()
    lineidx = lambda p: os.path.splitext(p)[0] + ".lineidx"
    return {"rows": len(rows), "lineidx_rows_ok": ids_ok,
            "split_merge_byte_equal": (read(merged) == read(fx["tsv"])
                                       and read(lineidx(merged))
                                       == read(lineidx(fx["tsv"])))}


def phase_data(work_dir: str, size: int = DATA_SIZE, sizes=DATA_SIZES) -> dict:
    """Host only. The data fixture; VGGrounding, DIODENormal and
    COCOKeypoint built by name through build_datasets, joined by
    ConcatDataset(repeats=DATA_REPEATS) and drawn through PrefetchLoader
    (4 workers, batch 1: the kinds' items differ in keys) for DATA_EPOCHS
    epochs: each epoch's items are the concatenation's items in the
    loader's shuffled order, every index once (a permutation); the TSV
    alone through PrefetchLoader at batch 4; every item's shapes, dtypes
    and ranges; the TSV's .lineidx and tsv_split/tsv_merge round trip."""
    import layoutllm_t2i_torch.data  # noqa: F401 (fills the catalog)
    from layoutllm_t2i_torch.data.concat import ConcatDataset, build_datasets
    from layoutllm_t2i_torch.data.loader import PrefetchLoader

    shutil.rmtree(work_dir, ignore_errors=True)
    t_phase = t0 = time.perf_counter()
    fx = data_fixture(os.path.join(work_dir, "root"), sizes)
    fixture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    datasets = build_datasets({name: {} for name in DATA_NAMES},
                              ROOT=fx["root"], image_size=size)
    concat = ConcatDataset(datasets, repeats=DATA_REPEATS)
    direct = {}  # (dataset, index) -> item, each decoded once
    for d_idx, i in concat._map:
        if (d_idx, i) not in direct:
            direct[d_idx, i] = datasets[d_idx][i]
    direct_s = time.perf_counter() - t0
    loader = PrefetchLoader(concat, 1, seed=0, num_workers=4)
    it = iter(loader)
    perm_ok, drawn = [], 0
    t0 = time.perf_counter()
    try:
        for epoch in range(DATA_EPOCHS):
            order = [idxs[0] for idxs in loader._epoch_batches(epoch)]
            same = sorted(order) == list(range(len(concat)))
            for idx in order:
                batch, want = next(it), direct[concat._map[idx]]
                drawn += 1
                same = same and all(
                    np.array_equal(batch[k][0], want[k]) if hasattr(want[k], "shape")
                    else batch[k][0] == want[k] for k in want)
            perm_ok.append(same)
    finally:
        it.close()
    loader_s = time.perf_counter() - t0
    tsv_it = iter(PrefetchLoader(datasets[0], 4, seed=0, num_workers=4))
    try:
        tsv_batch = next(tsv_it)
    finally:
        tsv_it.close()
    batch_ok = (tsv_batch["image"].shape == (4, size, size, 3)
                and tsv_batch["boxes"].shape == (4, datasets[0].max_boxes, 4)
                and len(tsv_batch["caption"]) == 4)
    checks = {f"{DATA_NAMES[d]}[{i}]": data_item_checks(item, size)
              for (d, i), item in direct.items()}
    items_ok = all(all(c.values()) for c in checks.values())
    tsv = tsv_round_trip(fx, work_dir)
    kinds = [type(ds).__name__ for ds in datasets]
    ok = (items_ok and all(perm_ok) and len(perm_ok) == DATA_EPOCHS
          and batch_ok and tsv["lineidx_rows_ok"]
          and tsv["split_merge_byte_equal"]
          and kinds == ["TSVGroundingDataset", "ConditionMapDataset",
                        "KeypointDataset"]
          and len(concat) == sum(r * len(ds) for r, ds in
                                 zip(DATA_REPEATS, datasets)))
    rec = {"phase": "data", "ok": ok, "wall_s": time.perf_counter() - t_phase,
           "image_size": size, "datasets": kinds,
           "lengths": [len(ds) for ds in datasets], "repeats": list(DATA_REPEATS),
           "concat_len": len(concat), "epochs_permutation": perm_ok,
           "items_drawn": drawn, "tsv_batch_ok": batch_ok, "tsv": tsv,
           "fixture_s": fixture_s, "decode_ms_per_item": 1e3 * direct_s / len(direct),
           "loader_ms_per_item": 1e3 * loader_s / max(drawn, 1),
           "failed_checks": {k: [n for n, v in c.items() if not v]
                             for k, c in checks.items() if not all(c.values())}}
    emit(rec)
    shutil.rmtree(work_dir, ignore_errors=True)
    if not ok:
        raise SmokeFailure("data: an item's shape, dtype or range is off, an "
                           "epoch is not a permutation of the dataset, or the "
                           "TSV's lineidx or split/merge round trip failed")
    return rec


# phase train-coco: the CLI on a COCO-2014-form fixture, 16 images of
# assorted sizes with one caption each (one caption keeps the per-step
# launch walk deterministic: the dataset's caption draw is shared by the
# loader's worker threads), a crowd box, a box the crop makes degenerate,
# and an image without a caption; batch 8, so 3 steps cross the epoch
COCO_SIZES = ((640, 480), (480, 640), (500, 333), (512, 512), (300, 200),
              (640, 427), (427, 640), (612, 612), (640, 360), (375, 500),
              (520, 520), (640, 512), (480, 360), (600, 400), (333, 500),
              (544, 640))
COCO_CATEGORIES = ("person", "dog", "cat", "car", "chair", "table", "horse",
                   "bench", "umbrella", "kite")
# "umbrella" only on the crowd box, "kite" only on the degenerate box
COCO_ABSENT = ("umbrella", "kite")
COCO_CAPTIONS = ("a dog to the left of a cat", "a man riding a horse on the beach",
                 "a cup on a table next to a chair", "two people sitting on a bench",
                 "a car parked behind a dog", "a cat sleeping on a chair",
                 "a person standing next to a horse", "a dog running under a table",
                 "a bench in front of a car", "a cat sitting above a dog",
                 "a person walking beside a car", "a chair next to a table",
                 "a horse standing near a bench", "a dog lying on a bench",
                 "a person holding a cat", "a car driving past a person")
COCO_STEPS = 3


def coco_fixture(work_dir: str, sizes=COCO_SIZES) -> dict:
    """COCO 2014's layout under ``work_dir``/coco: ``train2014/<n>.png``
    (utils/images.py PNGs at ``sizes``, then one more at the first size)
    and ``annotations/{instances,captions}_train2014.json`` (numpy seed
    0). Every image has 1-4 boxes; the first (landscape) one also a box
    at its left edge that the center crop leaves degenerate ("kite"), the
    second a crowd box ("umbrella"); each of ``sizes`` has one caption with
    a relation phrase, the extra image none."""
    from layoutllm_t2i_torch.utils.images import save_png

    rng = np.random.default_rng(0)
    root = os.path.join(work_dir, "coco")
    os.makedirs(os.path.join(root, "train2014"))
    os.makedirs(os.path.join(root, "annotations"))
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(COCO_CATEGORIES)]
    cat_id = {c["name"]: c["id"] for c in cats}
    inst = {"images": [], "annotations": [], "categories": cats}
    caps = {"annotations": []}
    for img_id, (w, h) in enumerate(tuple(sizes) + (sizes[0],), 1):
        name = f"{img_id:012d}.png"
        save_png(rng.integers(0, 256, (h, w, 3), np.uint8),
                 os.path.join(root, "train2014", name))
        inst["images"].append({"id": img_id, "file_name": name, "width": w,
                               "height": h})
        boxes = []
        for _ in range(int(rng.integers(1, 5))):
            x, y = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
            label = COCO_CATEGORIES[int(rng.integers(len(COCO_CATEGORIES) - 2))]
            boxes.append(([x, y, rng.uniform(0.2, 0.4) * w,
                           rng.uniform(0.2, 0.4) * h], label, 0))
        if img_id == 1:
            boxes.append(([0.0, 0.0, w / 20, h / 2], "kite", 0))
        if img_id == 2:
            boxes.append(([0.1 * w, 0.1 * h, 0.8 * w, 0.8 * h], "umbrella", 1))
        for box, label, crowd in boxes:
            inst["annotations"].append({
                "id": len(inst["annotations"]) + 1, "image_id": img_id,
                "bbox": [float(v) for v in box], "area": float(box[2] * box[3]),
                "category_id": cat_id[label], "iscrowd": crowd})
        if img_id <= len(sizes):
            caps["annotations"].append({
                "image_id": img_id,
                "caption": COCO_CAPTIONS[(img_id - 1) % len(COCO_CAPTIONS)]})
    for kind, obj in (("instances", inst), ("captions", caps)):
        with open(os.path.join(root, "annotations", f"{kind}_train2014.json"),
                  "w") as f:
            json.dump(obj, f)
    return {"root": root, "out": os.path.join(work_dir, "out"),
            "images": len(sizes) + 1, "captioned": len(sizes),
            "captionless_id": len(sizes) + 1}


def coco_walk(fx: dict, unet_cfg, vae_cfg, clip_cfg, tok_len, batch: int,
              size: int, steps: int = COCO_STEPS):
    """The CLI's loader rebuilt with its arguments (coco_layout_batches'
    seed 0): its first ``steps`` batches, the training walk over them
    (training_calls a batch, mixed precision), the loader's s a batch
    (4 workers, from a cold start) and one batch's decode s on one thread."""
    from layoutllm_t2i_torch.data.coco import coco_layout_batches

    loader = coco_layout_batches(fx["root"], batch, size, TRAIN_MAX_BOXES)
    it = iter(loader)
    t0 = time.perf_counter()
    try:
        batches = [next(it) for _ in range(steps)]
    finally:
        it.close()
    loader_s = (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    loader._fetch(loader._epoch_batches(0)[0])
    decode_s = time.perf_counter() - t0
    calls = []
    for b in batches:
        calls += training_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, b,
                                TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS)
    return {"batches": batches, "calls": calls, "dataset": loader.dataset,
            "loader_s_per_batch": loader_s, "decode_s_per_batch": decode_s}


def coco_batch_checks(walk: dict, fx: dict, batch: int, size: int) -> dict:
    """The first batch's shape; the dataset's length (the captionless image
    out); neither the crowd box's label nor the degenerate box's in any
    batch; the captions the fixture's, each with a relation."""
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_training

    labels = {lab for b in walk["batches"] for labs in b["labels"] for lab in labs}
    captions = {c for b in walk["batches"] for c in b["caption"]}
    ds = walk["dataset"]
    return {
        "first_batch_shape": walk["batches"][0]["image"].shape == (batch, size, size, 3),
        "dataset_len": len(ds) == fx["captioned"],
        "captionless_out": fx["captionless_id"] not in ds.ids,
        "crowd_and_degenerate_absent": not labels & set(COCO_ABSENT),
        "captions_ok": captions <= set(COCO_CAPTIONS),
        "relations_in_captions": all(
            relation_texts_for_training(c, TRAIN_MAX_RELATIONS)
            for c in captions)}


# the kernels of a mixed-precision training step: the bf16 UNet's and the
# f32 VAE encoder's and text encoder's
COCO_KIDS = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K1/f32", "K2/f32", "K3/f32")
# launched as often as the walk says (the others' counts depend on no batch
# either, but these carry the sites that a shape or an lse decides)
COCO_WALKED = ("K1", "K1/f32", "K5a", "K5b")


def cli_training_run(argv, name: str, output_root: str) -> tuple:
    """cli/train_diffusion.py main(argv) (``--output_root output_root
    --name name``) with every step logged (the CLI's TrainerConfig logs
    every 10th), its launches counted from 0: (its metrics.jsonl records,
    wall s, launches, peak GiB)."""
    from layoutllm_t2i_torch.cli import train_diffusion

    cfg_cls = train_diffusion.TrainerConfig
    train_diffusion.TrainerConfig = functools.partial(cfg_cls, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        _, wall, counts = counted(lambda: train_diffusion.main(
            list(argv) + ["--output_root", output_root, "--name", name]))
    finally:
        train_diffusion.TrainerConfig = cfg_cls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(output_root, name, "tag00", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f], wall, counts, peak


def phase_train_coco(work_dir: str) -> tuple:
    """cli/train_diffusion.py main with --coco_root on the fixture,
    --mixed_precision, batch 8, COCO_STEPS steps at full width (random
    SD-1.4 weights from seed 0, rela_fuse, AdamW): every loss finite, each
    kernel of COCO_KIDS launched, the launches of COCO_WALKED the walk's
    over the rebuilt loader's batches, the batch checks; s/step (the steps
    after the first), images/s, peak memory, the loader's and one thread's
    decode s a batch. Returns (launch counts, the walk's calls)."""
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    shutil.rmtree(work_dir, ignore_errors=True)
    t_phase = t0 = time.perf_counter()
    fx = coco_fixture(work_dir)
    fixture_s = time.perf_counter() - t0
    argv = ["--coco_root", fx["root"], "--mixed_precision",
            "--batch_size", str(TRAIN_BATCH), "--total_iters", str(COCO_STEPS),
            "--warmup_steps", "0"]
    recs, wall, counts, peak = cli_training_run(argv, "coco", fx["out"])
    losses = [r["loss"] for r in recs]
    each = [r["sec_per_iter"] for r in recs]
    s_step = sum(each[1:]) / max(len(each) - 1, 1)
    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    walk = coco_walk(fx, unet_cfg, vae_cfg, clip_cfg, clip_cfg.max_length,
                     TRAIN_BATCH, 512)
    walked = launches_of(walk["calls"])
    walk_ok = all(counts[kid] == walked.get(kid, 0) for kid in COCO_WALKED)
    checks = coco_batch_checks(walk, fx, TRAIN_BATCH, 512)
    launched = all(counts[kid] > 0 for kid in COCO_KIDS)
    ok = (len(losses) == COCO_STEPS and all(math.isfinite(x) for x in losses)
          and walk_ok and launched and all(checks.values()))
    emit({"phase": "train-coco", "ok": ok, "card": nvidia_smi_line(),
          "phase_wall_s": time.perf_counter() - t_phase,
          "batch": TRAIN_BATCH, "steps": COCO_STEPS,
          "images": fx["images"], "dataset_len": len(walk["dataset"]),
          "s_per_step": s_step, "s_per_step_each": each,
          "images_per_s": TRAIN_BATCH / s_step, "peak_mem_gib": peak,
          "wall_s": wall, "fixture_s": fixture_s, "losses": losses,
          "loader_s_per_batch": walk["loader_s_per_batch"],
          "decode_s_per_batch_one_thread": walk["decode_s_per_batch"],
          "checks": checks, "launches": counts,
          "walked": {kid: walked.get(kid, 0) for kid in COCO_WALKED},
          "launches_match_walk": walk_ok})
    shutil.rmtree(work_dir, ignore_errors=True)
    if not ok:
        raise SmokeFailure(
            "train-coco: a loss is not finite, a kernel of the step launched "
            "no time, K1's or K5's launches differ from the walk's, or a "
            "batch holds a crowd, degenerate or captionless entry")
    return counts, walk["calls"]


# phase train-hires: cli/train_diffusion.py --image_size 768 at batch 8,
# mixed precision and f32, TRAIN_HIRES_STEPS steps each
TRAIN_HIRES_SIDE = 768
TRAIN_HIRES_STEPS = 2
# the kernels whose launches a step must equal the walk's
TRAIN_HIRES_WALKED = ("K1", "K5a", "K5b")
# the geometries of its gradient checks (GEOMETRY), bf16 and f32 each
TRAIN_GRAD_GEOMETRIES = ("hires", "heads5", "heads2", "hires5", "heads1",
                         "hires1")
# its --ckpt_path runs: a reference-format .pth of the seed-0 weights whose
# config_dict sets GEOMETRY[geometry], trained through the CLI at batch
# TRAIN_BATCH in mixed precision, TRAIN_CKPT_STEPS steps, at each of
# TRAIN_CKPT_GEOMETRIES (num_heads 2: K5 at d 160 and 320; num_heads 1:
# 320 and 640)
TRAIN_CKPT_GEOMETRIES = ("heads2", "heads1")
TRAIN_CKPT_STEPS = 2


def write_gligen_pth(path: str, geometry: str) -> dict:
    """The seed-0 full-width weights (random_models, f32) written by the
    port's .pth writer (checkpoint/export.py export_gligen_checkpoint) with
    a reference GLIGEN config_dict whose model.params hold the UNet config
    changed as GEOMETRY[geometry] says (the weights do not depend on the
    head count: inner = heads x d_head = channels), and the VAE's and
    CLIP's configs as the port's trainer exports them. Returns the
    config_dict."""
    from layoutllm_t2i_torch.checkpoint.export import export_gligen_checkpoint
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    models = random_models(small=False, device="cuda", dtype=torch.float32,
                           seed=0)
    u = dataclasses.replace(models.unet_cfg, **GEOMETRY[geometry])
    config = {"model": {"params": {
        "image_size": u.image_size, "in_channels": u.in_channels,
        "model_channels": u.model_channels, "out_channels": u.out_channels,
        "num_res_blocks": u.num_res_blocks,
        "attention_resolutions": list(u.attention_resolutions),
        "channel_mult": list(u.channel_mult), "num_heads": u.num_heads,
        "transformer_depth": u.transformer_depth,
        "context_dim": u.context_dim, "fuser_type": u.fuser_type}},
        "vae_cfg": dataclasses.asdict(models.vae_cfg),
        "clip_cfg": dataclasses.asdict(models.clip_cfg)}
    export_gligen_checkpoint(path, models.unet_params.state_dict(),
                             models.vae_params.state_dict(),
                             models.clip_params.state_dict(), models.schedule,
                             config)
    del models
    torch.cuda.empty_cache()
    return config


def train_ckpt_cli(work_dir: str, geometry: str) -> dict:
    """A GLIGEN .pth at ``geometry`` (one of TRAIN_CKPT_GEOMETRIES) trained
    through the user's entry point: write_gligen_pth into ``work_dir``,
    then cli/train_diffusion.py main --synthetic --mixed_precision
    --ckpt_path at batch TRAIN_BATCH, TRAIN_CKPT_STEPS steps: finite
    losses, K1's, K5a's and K5b's launches the walk's (training_calls at
    the config), and K5's calls at GEOMETRY_K5_DIMS the walk's site by
    site; the .pth's size and write seconds, s/step, peak memory. Returns
    the launches."""
    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    t_phase = time.perf_counter()
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    path = os.path.join(work_dir, f"gligen_{geometry}.pth")
    config = write_gligen_pth(path, geometry)
    write_s, pth_gib = time.perf_counter() - t_phase, os.path.getsize(path) / 2 ** 30
    argv = ["--synthetic", "--mixed_precision", "--ckpt_path", path,
            "--batch_size", str(TRAIN_BATCH),
            "--total_iters", str(TRAIN_CKPT_STEPS), "--warmup_steps", "0"]
    with recorded_calls() as calls:
        logged, wall, counts, peak = cli_training_run(argv, "ckpt", work_dir)
    shutil.rmtree(work_dir, ignore_errors=True)
    losses = [r["loss"] for r in logged]
    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    walk = training_calls(
        dataclasses.replace(unet_cfg, **GEOMETRY[geometry]), vae_cfg, clip_cfg,
        clip_cfg.max_length,
        next(synthetic_layout_batches(TRAIN_BATCH, 512, TRAIN_MAX_BOXES)),
        TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS)
    walked = {kid: n for kid, n in launches_of(walk).items()
              if kid in TRAIN_HIRES_WALKED}
    dims = GEOMETRY_K5_DIMS[geometry]
    sites = sites_by_dim(calls, "K5a", dims)
    walked_sites = {key: n * TRAIN_CKPT_STEPS
                    for key, n in sites_by_dim(walk, "K5a", dims).items()}
    rec = {"phase": f"train-ckpt-{geometry}", "geometry": GEOMETRY[geometry],
           "num_heads": config["model"]["params"]["num_heads"],
           "card": nvidia_smi_line(), "batch": TRAIN_BATCH,
           "steps": TRAIN_CKPT_STEPS, "pth_gib": pth_gib, "write_s": write_s,
           "losses": losses, "s_per_step_each": [r["sec_per_iter"] for r in logged],
           "wall_s": wall, "peak_mem_gib": peak, "walked_per_step": walked,
           "k5_sites": {f"d{d} N{n} M{m}": c for (d, n, m), c in sorted(sites.items())},
           "launches_match_walk": all(counts[kid] == n * TRAIN_CKPT_STEPS
                                      for kid, n in walked.items()),
           "k5_match_walk": (sites == walked_sites
                             and {d for d, _, _ in sites} == set(dims)),
           "phase_s": time.perf_counter() - t_phase, "launches": counts}
    rec["ok"] = (len(losses) == TRAIN_CKPT_STEPS and rec["launches_match_walk"]
                 and rec["k5_match_walk"]
                 and all(math.isfinite(x) for x in losses))
    emit(rec)
    if not rec["ok"]:
        raise SmokeFailure(f"train-ckpt-{geometry}: a loss is not finite, or "
                           "K1's or K5's launches or K5's sites by head dim "
                           "differ from the walk's")
    return counts


def phase_train_hires(work_dir: str) -> dict:
    """SD-1.4 trained at 768^2 through the CLI, as the JAX trainer's
    --image_size takes it (the VAE encodes 96^2 latents; the UNet runs
    there): cli/train_diffusion.py main --synthetic --image_size 768 at
    batch 8, TRAIN_HIRES_STEPS steps, with --mixed_precision and again in
    f32 (random SD-1.4 weights from seed 0, rela_fuse, AdamW): finite
    losses, K1's, K5a's and K5b's launches (bf16 and f32) the walk's a
    step (training_calls at 768^2), s/step, peak memory. Then the
    rela_fuse gradients at batch 2 against plain_route() (phase
    train-grad's check, with its planted K5 fault), in bf16 and f32, at
    each of TRAIN_GRAD_GEOMETRIES (96^2 latents; num_heads 5 at 64^2;
    num_heads 2 at 64^2; num_heads 5 at 96^2; num_heads 1 at 64^2 and at
    96^2), K5's launches at GEOMETRY_K5_DIMS the walk's. Then
    train_ckpt_cli: a num_heads 2 and a num_heads 1 .pth through
    --ckpt_path. Returns the launch counts of all."""
    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    t_phase = time.perf_counter()
    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    batch = next(synthetic_layout_batches(TRAIN_BATCH, TRAIN_HIRES_SIDE,
                                          TRAIN_MAX_BOXES))
    total, recs, ok = {}, {}, True
    for mixed in (True, False):
        name = "mixed" if mixed else "f32"
        shutil.rmtree(work_dir, ignore_errors=True)
        argv = ["--synthetic", "--image_size", str(TRAIN_HIRES_SIDE),
                "--batch_size", str(TRAIN_BATCH),
                "--total_iters", str(TRAIN_HIRES_STEPS), "--warmup_steps", "0"] + (
                    ["--mixed_precision"] if mixed else [])
        logged, wall, counts, peak = cli_training_run(argv, "hires", work_dir)
        losses = [r["loss"] for r in logged]
        each = [r["sec_per_iter"] for r in logged]
        per_step = launches_of(training_calls(
            unet_cfg, vae_cfg, clip_cfg, clip_cfg.max_length, batch,
            TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS, f32=not mixed))
        walked = {kid: n for kid, n in per_step.items()
                  if kid.split("/")[0] in TRAIN_HIRES_WALKED}
        walk_ok = all(counts[kid] == n * TRAIN_HIRES_STEPS
                      for kid, n in walked.items())
        rec = {"ok": (len(losses) == TRAIN_HIRES_STEPS and walk_ok
                      and all(math.isfinite(x) for x in losses)),
               "mixed_precision": mixed, "losses": losses,
               "s_per_step_each": each, "wall_s": wall, "peak_mem_gib": peak,
               "launches": counts, "walked_per_step": walked,
               "launches_match_walk": walk_ok}
        recs[name] = rec
        ok = ok and rec["ok"]
        add_counts(total, counts)
        torch.cuda.empty_cache()
    shutil.rmtree(work_dir, ignore_errors=True)
    emit({"phase": "train-hires", "ok": ok, "card": nvidia_smi_line(),
          "side": TRAIN_HIRES_SIDE, "batch": TRAIN_BATCH,
          "steps": TRAIN_HIRES_STEPS, "wall_s": time.perf_counter() - t_phase,
          **recs})
    if not ok:
        raise SmokeFailure("train-hires: a loss is not finite or K1's or K5's "
                           "launches differ from the walk's at 768^2")
    for geometry in TRAIN_GRAD_GEOMETRIES:
        for mixed in (True, False):
            add_counts(total, phase_train_grad(
                mixed_precision=mixed, geometry=geometry,
                label=f"train-grad-{geometry}{'' if mixed else '-f32'}"))
    for geometry in TRAIN_CKPT_GEOMETRIES:
        add_counts(total, train_ckpt_cli(work_dir, geometry))
    return total


# device-time groups of the profile, matched in order against kernel names
# (the f32 instantiations of K2's and K3's templates before their bf16 ones).
# K6/f32 runs K4/f32's up and down kernels and K7/f32 K4/f32's LN pre-pass,
# so their time counts under K4/f32; K6/f32's group names them all the same
# ---------------------------------------------------------------------------
# phase parallel: parallel/ for generation (prompt-parallel and the TP
# latency mode), in ranks of their own started with torchrun's environment

PARALLEL_STEPS = 10            # a depth cut of PLMS-50 (PERF.md §4)
PARALLEL_PSNR_MIN_DB = 35.0    # tests/parity_setup.py's image gate
PARALLEL_CHILD_S = 420         # each rank's time limit
PARALLEL_GROUP_S = 300         # the group's collective timeout
PARALLEL_SERVE_REQUESTS = ("a dog chasing a red ball on the grass",
                           "a cat sitting on a wooden chair")


def parallel_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank on this machine. One hash seed
    for every rank: without a CLIP merges file the tokenizer hashes words
    with Python's salted ``hash``, and each rank's one-device reference
    must see the conditioning that rank 0 broadcasts."""
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PYTHONHASHSEED="0")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv, world: int, **popen) -> list:
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen([sys.executable] + argv, cwd=root,
                             env=parallel_env(r, world, port), **popen)
            for r in range(world)]


def wait_ranks(procs, timeout: float, what: str) -> None:
    """Every rank must exit 0 within ``timeout`` s: a hung collective or a
    failed rank fails the phase (the others are killed)."""
    deadline = time.perf_counter() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(1.0, deadline - time.perf_counter())))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if any(c != 0 for c in codes):
        raise SmokeFailure(f"{what}: ranks exited {codes}")


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def parallel_child(backend: str, out_dir: str, device: str = "cuda:0",
                   small: bool = False) -> int:
    """One rank of phase parallel (run by phase_parallel, torchrun's
    environment set): generate_sharded at batch 2 and generate_tp
    ('heads', 'spatial') at batch 1 against generate on the same requests,
    walls, launches and the K1 and K2 calls of the TP runs; at world 1 the
    port bench with --sharded. Writes OUT_DIR/rank<r>.json. gloo's ranks
    share ``device``; NCCL's take cuda:LOCAL_RANK. ``small``: the small
    geometry (a rehearsal on the CPU with device "cpu")."""
    import datetime

    from layoutllm_t2i_torch.kernels import group_norm, reset_launches
    from layoutllm_t2i_torch.parallel.mesh import make_mesh
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device=device if backend == "gloo" else None,
                     backend=backend,
                     timeout=datetime.timedelta(seconds=PARALLEL_GROUP_S))
    models = random_models(small=small, device=mesh.device,
                           dtype=None if small else torch.bfloat16, seed=0)
    set_alphas(models.unet_params, 0.5)
    pipe = InferencePipeline(models, steps=PARALLEL_STEPS, sampler="plms",
                             guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=VAE_CHUNK)
    prompts, layouts, relations = REQUESTS
    one = ([prompts[0]], [layouts[0]], [relations[0]])
    # warm-up: cuDNN's algorithm choices and first launches, every path
    warm = InferencePipeline(models, steps=2, alpha_type=(0.5, 0.0, 0.5),
                             vae_chunk=VAE_CHUNK)
    warm.generate_sharded(mesh, prompts, layouts, relations, seed=3)
    for style in ("heads", "spatial"):
        warm.generate_tp(mesh, *one, seed=3, style=style)
    rec = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), "steps": PARALLEL_STEPS, "walls_s": {},
           "psnr_db": {}}
    runs = {"sharded": lambda: pipe.generate_sharded(mesh, prompts, layouts,
                                                     relations, seed=0)}
    for style in ("heads", "spatial"):
        runs[style] = functools.partial(pipe.generate_tp, mesh, *one, seed=0,
                                        style=style)
    images, rec["launches_by_run"], rec["split_launches"] = {}, {}, 0
    with recorded_calls() as calls:
        for name, fn in runs.items():
            reset_launches()
            images[name], rec["walls_s"][name] = timed(fn)
            rec["launches_by_run"][name] = path_counts()
            rec["split_launches"] += group_norm.split_launches
    rec["launches"] = {kid: sum(c[kid] for c in rec["launches_by_run"].values())
                       for kid in rec["launches_by_run"]["sharded"]}
    # K1 at the local shapes, K2's split pair, K6 on a 'heads' inner slice
    rec["calls"] = sorted({(kid, args) for kid, args in calls
                           if kid in ("K1", "K6") or "split" in str(args)})
    # the one-device references, on each rank (its own images)
    refs = {}
    refs["sharded"], rec["walls_s"]["generate_b2"] = timed(
        lambda: pipe.generate(prompts, layouts, relations, seed=0))
    refs["heads"], rec["walls_s"]["generate_b1"] = timed(
        lambda: pipe.generate(*one, seed=0))
    refs["spatial"] = refs["heads"]
    for name, img in images.items():
        ok = (img.shape == refs[name].shape and bool(np.isfinite(img).all()))
        rec["psnr_db"][name] = (min(psnr_db(a, b) for a, b in
                                    zip(img, refs[name])) if ok else None)
    if mesh.size == 1:
        from layoutllm_t2i_torch.cli import bench

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--sharded", "--batch", "2", "--iters", "1",
                        "--steps", str(PARALLEL_STEPS), "--no_fast"]
                       + (["--small", "--device", device] if small else []))
        rec["bench"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def run_world(backend: str, world: int, out_dir: str) -> list:
    os.makedirs(out_dir, exist_ok=True)
    procs = spawn_ranks([os.path.abspath(__file__), "--parallel-child",
                         backend, out_dir], world)
    wait_ranks(procs, PARALLEL_CHILD_S, f"parallel world {world} {backend}")
    recs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def serve_tp_check(work_dir: str) -> dict:
    """cli/serve.py --tp at world 2, both ranks on cuda:0 over gloo: two
    POSTs answered with 512x512 PNGs, /metrics counting both, both ranks
    exiting 0 after rank 0's SIGINT."""
    import http.client
    import signal

    procs = spawn_ranks(
        ["-m", "layoutllm_t2i_torch.cli.serve", "--tp", "--device", "cuda:0",
         "--tp_backend", "gloo", "--steps", str(PARALLEL_STEPS), "--host",
         "127.0.0.1", "--port", "0"],
        2, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    rec = {"phase": "parallel-serve", "world": 2, "backend": "gloo"}
    try:
        line = next((l for l in procs[0].stdout
                     if l.startswith("serving on ")), "")
        if not line.startswith("serving on 127.0.0.1:"):
            raise SmokeFailure(f"serve --tp: no port line (rank 0 {procs[0].poll()})")
        conn = http.client.HTTPConnection(
            "127.0.0.1", int(line.split(":")[1].split()[0]), timeout=PARALLEL_CHILD_S)
        deadline = time.perf_counter() + PARALLEL_CHILD_S
        while http_json(conn, "GET", "/healthz")[0] != 200:
            if time.perf_counter() > deadline:
                raise SmokeFailure("serve --tp: not ready")
            time.sleep(0.5)
        http_json(conn, "POST", "/metrics/reset")
        rec["request_s"] = []
        for prompt in PARALLEL_SERVE_REQUESTS:
            t0 = time.perf_counter()
            conn.request("POST", "/generate", body=json.dumps({
                "prompt": prompt, "seed": 1,
                "layout": [{"phrase": prompt.split()[1],
                            "box": [0.1, 0.3, 0.6, 0.9]}]}))
            r = conn.getresponse()
            body = r.read()
            rec["request_s"].append(time.perf_counter() - t0)
            if r.status != 200 or png_pixels(body).shape != (512, 512, 3):
                raise SmokeFailure(f"serve --tp: reply {r.status}")
        rec["metrics"] = http_json(conn, "GET", "/metrics")[1]
        procs[0].send_signal(signal.SIGINT)
        wait_ranks(procs, 120, "serve --tp")
        rec["follower"] = procs[1].stdout.read().strip().splitlines()[-1:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    if rec["metrics"].get("requests") != 2 or rec["metrics"].get("errors"):
        raise SmokeFailure(f"serve --tp: /metrics {rec['metrics']}")
    return rec


def phase_parallel(work_dir: str) -> tuple:
    """World 1 on NCCL, world 2 on gloo with both ranks on cuda:0, serve
    --tp at world 2. Each run's images against generate's at PSNR >= 35 dB;
    world 2's K1 at the local shapes and K2's split pair launched. Returns
    (launches of the ranks' runs, their K1 and split K2 calls)."""
    t0 = time.perf_counter()
    worlds = {}
    for backend, world in (("nccl", 1), ("gloo", 2)):
        worlds[backend] = run_world(backend, world,
                                    os.path.join(work_dir, f"w{world}"))
        for rec in worlds[backend]:
            emit({"phase": "parallel", **{k: v for k, v in rec.items()
                                          if k != "calls"},
                  "note": ("world-1 walls" if world == 1 else
                           "shared-card walls: both ranks on one card, "
                           "collectives over gloo; not a TP speed-up")})
    counts, calls, bad = {}, set(), []
    for backend, recs in worlds.items():
        for rec in recs:
            for kid, n in rec["launches"].items():
                counts[kid] = counts.get(kid, 0) + n
            calls |= {(kid, tuple(args)) for kid, args in rec["calls"]}
            bad += [f"{backend} rank {rec['rank']} {k}: {v}"
                    for k, v in rec["psnr_db"].items()
                    if v is None or v < PARALLEL_PSNR_MIN_DB]
    counts["K2 split"] = sum(rec["split_launches"] for recs in worlds.values()
                             for rec in recs)
    split = worlds["gloo"][0]["split_launches"]
    # each run's own kernels: 'heads' at world 2 computes its FF partials
    # with K6 on a rank's inner slice (K4's LN and residual are whole-row)
    for backend, recs in worlds.items():
        for rec in recs:
            for run, got in rec["launches_by_run"].items():
                want = (("K1", "K2", "K3", "K6") if run == "heads"
                        and rec["world"] > 1 else ("K1", "K2", "K3", "K4"))
                bad += [f"{backend} rank {rec['rank']} {run}: no {kid} launch"
                        for kid in want if got.get(kid, 0) <= 0]
    k1_local = sorted(args for kid, args in calls if kid == "K1")
    want = {(2 * 1, 2048, 4096, 8, 40), (2 * 1, 4096, 4096, 4, 40)}
    bench = worlds["nccl"][0]["bench"]
    serve = serve_tp_check(work_dir)
    emit({**serve, "seconds": time.perf_counter() - t0,
          "k1_calls": k1_local, "split_launches_rank0": split})
    if bad:
        raise SmokeFailure(f"parallel (images under {PARALLEL_PSNR_MIN_DB} dB "
                           f"or a run's kernel not launched): {bad}")
    if not want <= set(k1_local) or split <= 0:
        raise SmokeFailure(f"parallel: K1 at {k1_local} (want {sorted(want)}), "
                           f"{split} split K2 launches")
    if not (bench["value"] > 0 and 0 < bench["mfu"] <= 1 and bench["ranks"] == 1):
        raise SmokeFailure(f"bench --sharded: {bench}")
    return counts, sorted(calls)


# ---------------------------------------------------------------------------
# phase train-dp: parallel/ for training (the data-parallel DiffusionTrainer,
# ZeRO-1 and the CLI under torchrun's environment), in ranks of their own

TRAIN_DP_STEPS = 3
TRAIN_DP_LOSS_REL_TOL = 1e-4     # each logged loss against world 1's
# world 2's update of the trained tensors against world 1's (relative L2):
# 6.1e-6 on the card; a rank updating from its own rows alone reads ~1
TRAIN_DP_UPDATE_REL_TOL = 1e-3
TRAIN_DP_CLI_STEPS = 2


def train_dp_child(backend: str, out_dir: str, device: str = "cuda:0",
                   small: bool = False) -> int:
    """One rank of phase train-dp (torchrun's environment set): the
    DiffusionTrainer at full width in f32 (TrainerConfig()'s precision),
    rela_fuse, AdamW, TRAIN_DP_STEPS steps on the seeded synthetic global
    batches of TRAIN_BATCH, this rank's rows of each. Every run starts
    from the same random weights (seed 0, gates 0.5). World 1 writes the
    first step's gradient, the losses and the trained tensors to
    OUT_DIR/w1_reference.pt; world 2 runs once plain and once with ZeRO-1
    and holds them to world 1 and to each other. Writes
    OUT_DIR/w<world>_rank<r>.json: walls, peak memory, moment bytes, each
    run's launches and the walk of one step at the local batch, the kernel
    calls. ``small``: the small geometry (a rehearsal on the CPU with
    device "cpu")."""
    import datetime

    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.kernels import reset_launches
    from layoutllm_t2i_torch.parallel.mesh import batch_rows, make_mesh, take_rows
    from layoutllm_t2i_torch.pipeline.loaders import random_models
    from layoutllm_t2i_torch.training.diffusion_trainer import (
        DiffusionTrainer, TrainerConfig)
    from layoutllm_t2i_torch.training.train_step import rela_fuse_only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms: the plain and the ZeRO-1 run must
    # get the same gradients bit for bit for their updates to be compared
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh(device=device if backend == "gloo" else None,
                     backend=backend,
                     timeout=datetime.timedelta(seconds=PARALLEL_GROUP_S))
    on_card = mesh.device.type == "cuda"
    models = random_models(small=small, device=mesh.device,
                           dtype=torch.float32, seed=0)
    set_alphas(models.unet_params, 0.5)
    start = {n: p.detach().clone()
             for n, p in models.unet_params.named_parameters()
             if rela_fuse_only(n)}
    side = 16 if small else 512
    rows = batch_rows(TRAIN_BATCH, mesh)
    batches = lambda: (take_rows(b, rows) for b in synthetic_layout_batches(
        TRAIN_BATCH, side, TRAIN_MAX_BOXES))
    m = models
    rec = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), "steps": TRAIN_DP_STEPS,
           "batch": TRAIN_BATCH, "local_batch": len(rows), "runs": {},
           "walk_per_step": launches_of(training_calls(
               m.unet_cfg, m.vae_cfg, m.clip_cfg, m.clip_cfg.max_length,
               next(batches()), TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS,
               f32=True))}
    ref_path = os.path.join(out_dir, "w1_reference.pt")
    ref = (None if mesh.size == 1 else
           torch.load(ref_path, map_location="cpu", weights_only=True))
    plain, all_calls = None, set()
    for variant in ("plain",) if mesh.size == 1 else ("plain", "zero1"):
        with torch.no_grad():
            for n, p in models.unet_params.named_parameters():
                if n in start:
                    p.copy_(start[n])
        cfg = TrainerConfig(
            output_root=os.path.join(out_dir, f"w{mesh.size}_{variant}"),
            name="train_dp", batch_size=TRAIN_BATCH,
            total_iters=TRAIN_DP_STEPS, save_every_iters=10 ** 9, log_every=1,
            warmup_steps=0, trainable_mode="rela_fuse", optimizer="adamw",
            max_boxes=TRAIN_MAX_BOXES, max_relations=TRAIN_MAX_RELATIONS,
            zero1_opt_state=variant == "zero1")
        trainer = DiffusionTrainer(cfg, batches(), models=models, mesh=mesh)
        # the CLI drive below writes this phase's checkpoint
        trainer.save_ckpt = lambda iter_name: None
        step = trainer.train_step
        first_grad, update = [], step.update

        def spy(grads):
            if not first_grad:   # the all-reduced gradient, on the host
                first_grad.extend(g.detach().to("cpu", copy=True)
                                  for g in grads)
            update(grads)
        step.update = spy
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with recorded_calls() as calls:
            t0 = time.perf_counter()
            trainer.train()
            sync()
            wall = time.perf_counter() - t0
        all_calls |= {(kid, tuple(args)) for kid, args in calls}
        run = {"wall_s": wall, "launches": path_counts(),
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if on_card else None),
               "moment_bytes": sum(t.numel() * t.element_size() for t in
                                   step.optimizer.mu + step.optimizer.nu),
               "moment_bytes_whole": sum(
                   2 * p.numel() * p.element_size()
                   for p in step.params.values()),
               "moment_bytes_want": sum(
                   2 * p.numel() * p.element_size() // (
                       mesh.size if d is not None else 1)
                   for p, d in zip(step.params.values(), step.zero1_dims)),
               "trainable_tensors": len(step.params),
               "trainable_params": sum(p.numel() for p in step.params.values())}
        trained = {n: p.detach().to("cpu", copy=True)
                   for n, p in step.params.items()}
        if mesh.rank == 0:
            with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            run["losses"] = [r["loss"] for r in recs]
            run["s_per_step_each"] = [r["sec_per_iter"] for r in recs]
        if ref is None and mesh.rank == 0:
            torch.save({"grad": first_grad, "losses": run["losses"],
                        "params": trained}, ref_path)
        if ref is not None and variant == "plain":
            run["grad_rel_l2_err"] = rel_l2(first_grad, ref["grad"])
            if mesh.rank == 0:
                run["loss_rel_err"] = max(
                    abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                        ref["losses"]))
            run["param_max_abs_diff"] = max(
                float((trained[n] - p).abs().max())
                for n, p in ref["params"].items())
            run["param_bound"] = (2 * cfg.base_learning_rate
                                  * TRAIN_DP_STEPS)
            # how close the two runs' updates are, whole tensors together
            run["update_rel_l2_err"] = rel_l2(
                [trained[n] - start[n].cpu() for n in ref["params"]],
                [p - start[n].cpu() for n, p in ref["params"].items()])
            plain = trained, first_grad
        if variant == "zero1":
            run["bit_equal_to_plain"] = all(
                torch.equal(trained[n], p) for n, p in plain[0].items())
            run["first_grad_bit_equal_to_plain"] = all(
                torch.equal(a, b) for a, b in zip(first_grad, plain[1]))
            run["tensors_differing_from_plain"] = sum(
                not torch.equal(trained[n], p) for n, p in plain[0].items())
            run["max_abs_diff_from_plain"] = max(
                float((trained[n] - p).abs().max()) for n, p in plain[0].items())
        rec["runs"][variant] = run
        del trainer, step, first_grad, trained
        if on_card:
            torch.cuda.empty_cache()
    rec["calls"] = sorted(all_calls)
    with open(os.path.join(out_dir, f"w{mesh.size}_rank{mesh.rank}.json"),
              "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def train_dp_cli(work_dir: str) -> dict:
    """cli/train_diffusion.py --synthetic --zero1 --multihost --backend gloo
    at world 2 on cuda:0: both ranks exit 0 and one run directory, tag00,
    holds the checkpoint of its last step."""
    out = os.path.join(work_dir, "cli")
    procs = spawn_ranks(
        ["-m", "layoutllm_t2i_torch.cli.train_diffusion", "--synthetic",
         "--zero1", "--multihost", "--backend", "gloo", "--device", "cuda:0",
         "--batch_size", str(TRAIN_BATCH), "--total_iters",
         str(TRAIN_DP_CLI_STEPS), "--warmup_steps", "0", "--output_root",
         out, "--name", "train_dp"], 2)
    t0 = time.perf_counter()
    wait_ranks(procs, PARALLEL_CHILD_S, "train_diffusion --zero1 --multihost")
    tags = sorted(os.listdir(os.path.join(out, "train_dp")))
    ckpt = os.path.join(out, "train_dp", "tag00",
                        f"checkpoint_{TRAIN_DP_CLI_STEPS:08d}", "state.pt")
    return {"phase": "train-dp-cli", "world": 2, "backend": "gloo",
            "steps": TRAIN_DP_CLI_STEPS, "wall_s": time.perf_counter() - t0,
            "note": "shared-card wall: both ranks on one card, with process "
                    "start, model build and the checkpoint",
            "run_dirs": tags, "checkpoint": os.path.exists(ckpt),
            "ok": tags == ["tag00"] and os.path.exists(ckpt)}


def phase_train_dp(work_dir: str) -> tuple:
    """World 1 on NCCL, then world 2 on gloo with both ranks on cuda:0
    (plain and ZeRO-1), then the training CLI at world 2. World 2's first
    all-reduced gradient within TRAIN_GRAD_F32_REL_TOL of world 1's, each
    logged loss within TRAIN_DP_LOSS_REL_TOL, the update of the trained
    tensors within TRAIN_DP_UPDATE_REL_TOL of world 1's, every trained
    tensor within 2 lr a step of world 1's (a sanity bound only: AdamW
    moves an element by about lr a step at most); ZeRO-1 bit-equal to plain on every rank, its moments a rank the
    zero1_dim share of the whole; each rank's K1, K5a, K5b and K4 launches
    (f32) the walk's at its local batch, K2 and K3 launched. Returns
    (launches of the ranks' runs, their kernel calls)."""
    t0 = time.perf_counter()
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    recs = []
    for backend, world in (("nccl", 1), ("gloo", 2)):
        procs = spawn_ranks([os.path.abspath(__file__), "--train-dp-child",
                             backend, work_dir], world)
        wait_ranks(procs, PARALLEL_CHILD_S, f"train-dp world {world} {backend}")
        for r in range(world):
            with open(os.path.join(work_dir, f"w{world}_rank{r}.json")) as f:
                recs.append(json.load(f))
            emit({"phase": "train-dp", **{k: v for k, v in recs[-1].items()
                                          if k != "calls"},
                  "note": ("world-1 walls" if world == 1 else
                           "shared-card walls: both ranks on one card, "
                           "collectives over gloo; not a DP speed-up")})
    cli = train_dp_cli(work_dir)
    emit({**cli, "seconds": time.perf_counter() - t0})
    bad = train_dp_faults(recs)
    if not cli["ok"]:
        bad.append(f"cli: {cli['run_dirs']}, checkpoint {cli['checkpoint']}")
    if bad:
        raise SmokeFailure(f"train-dp: {bad}")
    counts, calls = {}, set()
    for rec in recs:
        calls |= {(kid, tuple(args)) for kid, args in rec["calls"]}
        for run in rec["runs"].values():
            for kid, n in run["launches"].items():
                counts[kid] = counts.get(kid, 0) + n
    return counts, sorted(calls)


def train_dp_faults(recs, launches: bool = True) -> list:
    """What phase train-dp's rank records break, as strings (none: the
    phase holds). ``launches`` False: skip the launch checks (a rehearsal
    on the CPU launches no kernel)."""
    bad = []
    walked = ("K1/f32", "K5a/f32", "K5b/f32", "K4/f32")
    for rec in recs:
        who = f"world {rec['world']} rank {rec['rank']}"
        for variant, run in rec["runs"].items():
            got = run["launches"]
            if launches:
                bad += [f"{who} {variant}: {kid} {got.get(kid, 0)} launches, "
                        f"walk {rec['walk_per_step'].get(kid, 0)} x "
                        f"{rec['steps']}" for kid in walked if got.get(kid, 0)
                        != rec["walk_per_step"].get(kid, 0) * rec["steps"]]
                bad += [f"{who} {variant}: no {kid} launch"
                        for kid in ("K2/f32", "K3/f32") if got.get(kid, 0) <= 0]
            if rec["world"] == 1:
                continue
            if variant == "zero1":
                if not run["bit_equal_to_plain"]:
                    bad.append(f"{who}: ZeRO-1 not bit-equal to plain DP")
                if not (run["moment_bytes"] == run["moment_bytes_want"]
                        and 2 * run["moment_bytes"]
                        <= run["moment_bytes_whole"] * 1.001):
                    bad.append(f"{who}: ZeRO-1 moments {run['moment_bytes']} B")
                continue
            if run["grad_rel_l2_err"] > TRAIN_GRAD_F32_REL_TOL:
                bad.append(f"{who}: gradient {run['grad_rel_l2_err']}")
            if not run["update_rel_l2_err"] <= TRAIN_DP_UPDATE_REL_TOL:
                bad.append(f"{who}: update {run['update_rel_l2_err']}")
            if run["param_max_abs_diff"] > run["param_bound"]:
                bad.append(f"{who}: tensors {run['param_max_abs_diff']}")
            if rec["rank"] == 0 and not (
                    run["loss_rel_err"] <= TRAIN_DP_LOSS_REL_TOL
                    and len(run["losses"]) == TRAIN_DP_STEPS
                    and all(math.isfinite(x) for x in run["losses"])):
                bad.append(f"{who}: losses {run['losses']}")
    return bad


PROFILE_GROUPS = (
    # the split pre-pass's four-operand instantiations run in K5a/f32's
    # call (the backward's, shared with K5b/f32), its two-operand ones in
    # K1/f32's
    ("K5a/f32 flash_attention_bwd_dq", ("flash_bwd_dq_f32_ss_kernel",
                                        "flash_bwd_dq_f32_stream_kernel",
                                        "flash_bwd_dq_f32_wide_kernel",
                                        "flash_split_cols_f32_kernel<4>",
                                        *(f"flash_split_f32_kernel<{w}, 4>"
                                          for w in (40, 64, 80, 128, 160,
                                                    256, 320)))),
    ("K5b/f32 flash_attention_bwd_dkv", ("flash_bwd_dkv_f32_ss_kernel",
                                         "flash_bwd_dkv_f32_stream_kernel",
                                         "flash_bwd_dkv_f32_wide_kernel")),
    ("K1/f32 flash_attention", ("flash_fwd_f32_ss_kernel",
                                "flash_split_f32_kernel",
                                "flash_fwd_f32_wgmma_kernel",
                                "flash_split_cols_f32_kernel",
                                "flash_fwd_f32_wide_kernel")),
    ("K2/f32 group_norm", tuple(f"{k}<float>" for k in GN_KERNELS)),
    ("K3/f32 layer_norm", ("ln_kernel<float",)),
    ("K7/f32 ffn_ln_geglu_q", ("ffn_q_up_f32_wgmma_kernel",
                               "ffn_q_down_f32_wgmma_kernel")),
    ("K4/f32 ffn_ln_geglu (+ K6/f32, K7/f32's LN)",
     ("ffn_norm_rows_f32_kernel", "ffn_up_f32_wgmma_kernel",
      "ffn_down_f32_wgmma_kernel")),
    ("K6/f32 ffn_geglu", ("ffn_up_f32_wgmma_kernel", "ffn_down_f32_wgmma_kernel")),
    ("K8a/f32 linear_fused", ("linear_f32_wgmma_kernel",)),
    ("K8b/f32 geglu_fused", ("geglu_f32_wgmma_kernel",)),
    ("K1 flash_attention", ("flash_fwd_kernel", "flash_fwd_wide_kernel")),
    ("K5a flash_attention_bwd_dq", ("flash_bwd_dq_kernel",
                                    "flash_bwd_dq_wide_kernel")),
    ("K5b flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",
                                     "flash_bwd_dkv_wide_kernel")),
    ("K2 group_norm", GN_KERNELS),
    ("K3 layer_norm", ("ln_kernel",)),
    ("K4 ffn_ln_geglu", ("ffn_norm_rows_kernel", "ffn_up_wgmma_kernel",
                         "ffn_down_wgmma_kernel")),
    ("K6 ffn_geglu", ("ffn_res_up_wgmma_kernel",
                      "ffn_res_down_wgmma_kernel")),
    ("K7 ffn_ln_geglu_q", ("ffn_q_norm_rows_kernel", "ffn_q_up_wgmma_kernel",
                           "ffn_q_down_wgmma_kernel")),
    ("K8a linear_fused", ("linear_wgmma_kernel",)),
    ("K8b geglu_fused", ("geglu_wgmma_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "nhwc", "fprop",
                     "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("softmax", ("softmax",)),
)


def profile_train_step(trainer, data, name: str, profile: str) -> None:
    """One more training step of ``trainer`` on the next batch of ``data``
    under the profiler, into the profile's path with ``_<name>.json``."""
    it = iter(data)
    profile_device(
        lambda: trainer.train_step(trainer.prepare_batch(next(it)),
                                   trainer.generator),
        f"profile-{name}", os.path.splitext(profile)[0] + f"_{name}.json",
        batch=TRAIN_BATCH)


def profile_device(run, label: str, out_path: str, **extra) -> None:
    """``run()`` once under torch.profiler, tracing the device only (each
    kernel counted once, and little host overhead): device time by kernel
    group (the summed times of each group's kernels, from key_averages),
    the device's busy time (utils/profiling.py union_ms: the union of the
    trace's activity intervals, so activities that overlap count once) and
    its idle share of the wall time; the full per-kernel table goes to ``out_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from layoutllm_t2i_torch.utils.profiling import traced_intervals, union_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace_path = os.path.splitext(out_path)[0] + "_trace.json"
    intervals = traced_intervals(prof, trace_path)
    os.remove(trace_path)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue  # a host op: its kernels are listed on their own
        if evt.self_device_time_total > 0:
            rows.append({"name": evt.key, "calls": evt.count,
                         "device_ms": evt.self_device_time_total / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for r in rows:
        low = r["name"].lower()
        name = next((g for g, keys in PROFILE_GROUPS
                     if any(k in low for k in keys)), "other")
        groups[name] += r["device_ms"]
    busy = union_ms(intervals)
    summary = {"phase": label, **extra, "wall_ms": wall * 1e3,
               "device_busy_ms": busy,
               "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
               "device_group_sum_ms": sum(groups.values()),
               "device_trace_sum_ms": sum(b - a for a, b in intervals) / 1e3,
               "device_activities": len(intervals),
               "device_ms_by_group": groups}
    with open(out_path, "w") as f:
        json.dump({**summary, "kernels": rows}, f, indent=1)
    emit(summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="JSON",
                    help="after the checks, profile one more generation on "
                         "each route, of the fast preset, of the bench's "
                         "exact path at batch 8 and of the f32 bundle, "
                         "dense and int8, and one more training step of "
                         "each training phase, and write their per-kernel "
                         "device times here and to JSON_fast, JSON_int8, "
                         "JSON_routes, JSON_bench, JSON_train, "
                         "JSON_train-f32, JSON_f32, JSON_int8-f32 and "
                         "JSON_routes-f32")
    ap.add_argument("--parallel-child", nargs=2, metavar=("BACKEND", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of phase parallel
    ap.add_argument("--train-dp-child", nargs=2, metavar=("BACKEND", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of phase train-dp
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.parallel_child:
        return parallel_child(*args.parallel_child)
    if args.train_dp_child:
        return train_dp_child(*args.train_dp_child)
    try:
        from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
        from layoutllm_t2i_torch.models.clip_text import CLIPTextConfig
        from layoutllm_t2i_torch.models.clip_vision import CLIPVisionConfig
        from layoutllm_t2i_torch.pipeline.loaders import model_configs, random_models
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0))})
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    work_dir = os.path.join(build_dir, "chip_smoke_train")
    cli_dir = os.path.join(build_dir, "chip_smoke_cli")
    rl_dir = os.path.join(build_dir, "chip_smoke_rl")
    eval_dir = os.path.join(build_dir, "chip_smoke_eval")
    modal_dir = os.path.join(build_dir, "chip_smoke_modalities")
    data_dir = os.path.join(build_dir, "chip_smoke_data")
    coco_dir = os.path.join(build_dir, "chip_smoke_coco")
    parallel_dir = os.path.join(build_dir, "chip_smoke_parallel")
    train_dp_dir = os.path.join(build_dir, "chip_smoke_train_dp")
    try:
        with route_env(DEFAULT):
            phase_build()
            # its ranks start from the libraries phase build made
            parallel_counts, parallel_calls = phase_parallel(parallel_dir)
            train_dp_counts, train_dp_calls = phase_train_dp(train_dp_dir)
            shutil.rmtree(train_dp_dir, ignore_errors=True)
            unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
            tok_len = clip_cfg.max_length
            train_batch = next(synthetic_layout_batches(TRAIN_BATCH, 512,
                                                        TRAIN_MAX_BOXES))
            gen_paths = {
                f"generate{suffix}": generation_calls(
                    unet_cfg, vae_cfg, clip_cfg, tok_len, REQUESTS, VAE_CHUNK,
                    route=route)
                for suffix, route in (("", DEFAULT), ("-int8", INT8),
                                      ("-routes", SPLIT))}
            gen_paths["fast"] = generation_calls(
                unet_cfg, vae_cfg, clip_cfg, tok_len, REQUESTS, VAE_CHUNK,
                evals=unet_evaluations(fast_tables_pipeline(), len(REQUESTS[0])))
            # the bench's default run: 8 requests, CFG batch 16 (exact) and
            # CFG 16 / cond-only 8 (fast)
            bench_exact, bench_fast = bench_pipelines(tables_models())
            for name, pipe in (("bench", bench_exact), ("bench-fast", bench_fast)):
                gen_paths[name] = generation_calls(
                    unet_cfg, vae_cfg, clip_cfg, tok_len, bench_requests(),
                    VAE_CHUNK, evals=unet_evaluations(pipe, BENCH_BATCH))
            gen_paths["cli"] = cli_paths(unet_cfg, vae_cfg, clip_cfg, tok_len)
            gen_paths["rl"] = rl_calls(unet_cfg, vae_cfg, clip_cfg,
                                       CLIPTextConfig(), CLIPVisionConfig(),
                                       tok_len)
            gen_paths["eval"] = eval_paths(unet_cfg, vae_cfg, clip_cfg,
                                           tok_len, CLIPTextConfig(),
                                           CLIPVisionConfig())
            # phase train's preview: the batch after its TRAIN_STEPS steps
            gen_paths["preview"] = preview_calls(
                unet_cfg, vae_cfg, clip_cfg, tok_len,
                next(itertools.islice(synthetic_layout_batches(
                    TRAIN_BATCH, 512, TRAIN_MAX_BOXES), TRAIN_STEPS, None)))
            # the f32 bundle's generations: dense, and int8 through K7/f32
            for name, route in (("generate-f32", DEFAULT),
                                ("int8-f32", INT8)):
                gen_paths[name] = generation_calls(
                    unet_cfg, vae_cfg, clip_cfg, tok_len, REQUESTS, VAE_CHUNK,
                    route=route, f32=True)
            # K1 and K5 at head dims no model here routes to them
            gen_paths["head-dim"] = HEAD_DIM_CALLS
            # phases hires, heads5 and train-hires: SD-1.4 at 768^2 and
            # num_heads 5, generation and a batch-8 training step, bf16
            # and f32 (K1 at d 160, 64 and 128; K5 at the lse sites);
            # phases heads1 and hires1: num_heads 1, generation (K1 at d
            # 320, 640 and 1280; its training: the gradient checks' sites
            # and train-ckpt's walk below)
            hires_batch = next(synthetic_layout_batches(
                TRAIN_BATCH, TRAIN_HIRES_SIDE, TRAIN_MAX_BOXES))
            for name in GEOMETRY_RUNS:
                cfg_g = dataclasses.replace(unet_cfg, **GEOMETRY[name])
                for f32, tag in ((False, ""), (True, "-f32")):
                    gen_paths[f"{name}{tag}"] = generation_calls(
                        cfg_g, vae_cfg, clip_cfg, tok_len, REQUESTS,
                        VAE_CHUNK, f32=f32)
                    if name in GENERATION_ONLY:
                        continue
                    gen_paths[f"train-{name}{tag}"] = training_calls(
                        cfg_g, vae_cfg, clip_cfg, tok_len,
                        hires_batch if name == "hires" else train_batch,
                        TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS, f32=f32)
            del hires_batch
            # phase train-hires' --ckpt_path runs: num_heads 2 and 1, mixed
            # precision, batch 8 (K1 with its lse and K5 at d 160 and 320,
            # and at 320 and 640)
            for name in TRAIN_CKPT_GEOMETRIES:
                gen_paths[f"train-{name}"] = training_calls(
                    dataclasses.replace(unet_cfg, **GEOMETRY[name]),
                    vae_cfg, clip_cfg, tok_len, train_batch, TRAIN_MAX_BOXES,
                    TRAIN_MAX_RELATIONS)
            # phase train-hires' gradient checks at num_heads 2 and 5 at
            # 768^2 (K5 at the 256 and 320 widths) and num_heads 1 at 512^2
            # and 768^2 (past 320: the column groups), bf16 and f32
            for name in WIDE_K5_GEOMETRIES:
                for mixed, tag in ((True, ""), (False, "-f32")):
                    gen_paths[f"train-grad-{name}{tag}"] = wide_k5_sites(
                        unet_cfg, name, mixed)
            first_cases = kernel_cases({
                **gen_paths,
                **{name: training_calls(unet_cfg, vae_cfg, clip_cfg, tok_len,
                                        train_batch, TRAIN_MAX_BOXES,
                                        TRAIN_MAX_RELATIONS, f32=f32,
                                        route=route)
                   for name, f32, route in (("train", False, DEFAULT),
                                            ("train-f32", True, DEFAULT),
                                            ("routes-f32", True, SPLIT))}})
            kernels_acc = phase_kernels(first_cases)
            del train_batch
            models = random_models(small=False, device="cuda",
                                   dtype=torch.bfloat16, seed=0)
            phase_unet(models)
            gen_counts, dense_img = phase_generate(models)
            profile_generation(models, "profile", args.profile, "")
            fast_counts, fast_pipe = phase_fast(models, dense_img)
            if args.profile:
                profile_device(lambda: fast_pipe.generate(*REQUESTS, seed=0),
                               "profile-fast",
                               os.path.splitext(args.profile)[0] + "_fast.json",
                               steps=fast_pipe.steps)
            phase_serve(fast_pipe)
            del fast_pipe
            int8_counts = phase_int8(models, dense_img, args.profile)
            routes_counts = phase_routes(models, args.profile)
            inpaint_counts, inpaint_calls = phase_inpaint(models, dense_img)
            del models
            torch.cuda.empty_cache()
            modal_counts, modal_calls = phase_modalities(modal_dir, dense_img[0])
            torch.cuda.empty_cache()
            geometry_counts = {name: phase_geometry(name)[0]
                               for name in GEOMETRY_RUNS}
            torch.cuda.empty_cache()
            bench_counts = phase_bench(args.profile)
            torch.cuda.empty_cache()
            cli_counts, cli_calls = phase_cli(cli_dir, dense_img[0])
            torch.cuda.empty_cache()
            # phase kernels' second pass: the shapes that phases parallel,
            # train-dp, inpaint, modalities and cli recorded and the first
            # pass did not hold
            held = {(kid, a) for kid, _, a, _ in first_cases}
            second_cases = [case for case in kernel_cases(
                {"inpaint": inpaint_calls, "modalities": modal_calls,
                 "cli": cli_calls, "parallel": parallel_calls,
                 "train-dp": train_dp_calls})
                if (case[0], case[2]) not in held]
            kernels_acc = phase_kernels(second_cases, kernels_acc)
            held |= {(kid, a) for kid, _, a, _ in second_cases}
            del inpaint_calls, modal_calls, cli_calls, second_cases
            rl_counts = phase_rl(rl_dir)
            torch.cuda.empty_cache()
            eval_counts = phase_eval(eval_dir)
            torch.cuda.empty_cache()
            train_counts = {}
            for mixed, suffix in ((True, ""), (False, "-f32")):
                phase_train_grad(mixed_precision=mixed)
                train_counts[suffix], trainer, data = phase_train(
                    work_dir, mixed_precision=mixed)
                if mixed:
                    preview_counts = phase_train_preview(trainer, data)
                if args.profile:
                    profile_train_step(trainer, data, f"train{suffix}",
                                       args.profile)
                trainer.close()
                del trainer, data
                torch.cuda.empty_cache()
                if not mixed:
                    continue
                phase_data(data_dir)
                coco_counts, coco_calls = phase_train_coco(coco_dir)
                torch.cuda.empty_cache()
                # phase kernels' third pass: the shapes of train-coco's walk
                # (its grounding texts' encoder batches) the passes before
                # did not hold
                kernels_acc = phase_kernels(
                    [case for case in kernel_cases({"train-coco": coco_calls})
                     if (case[0], case[2]) not in held], kernels_acc)
                del coco_calls
            train_hires_counts = phase_train_hires(work_dir)
            torch.cuda.empty_cache()
            gen_f32_counts, models, img = phase_generate_f32(dense_img)
            profile_generation(models, "profile-f32", args.profile, "_f32.json")
            int8_f32_counts = phase_int8(models, img, args.profile,
                                         label="int8-f32")
            del models, img, dense_img
            torch.cuda.empty_cache()
            routes_f32_counts = phase_routes_f32(work_dir, args.profile)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
        shutil.rmtree(cli_dir, ignore_errors=True)
        shutil.rmtree(rl_dir, ignore_errors=True)
        shutil.rmtree(eval_dir, ignore_errors=True)
        shutil.rmtree(modal_dir, ignore_errors=True)
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(coco_dir, ignore_errors=True)
        shutil.rmtree(parallel_dir, ignore_errors=True)
        shutil.rmtree(train_dp_dir, ignore_errors=True)
    summary, k5_pairs, _ = kernels_acc
    # each run launches its path's kernels: the exact and the fast
    # generation, the bench, the CLIs, the RL trainer, the NSS1K runs and
    # the training preview K1-K4 (K3 also in f32: the reward's towers, the
    # trainer's text encoder), the int8 generation K7, the split routes K6,
    # K8a and K8b, mixed-precision training K1-K5b in bf16 and its encoders'
    # K1 (d 512), K2 and K3 in f32, f32 training the f32 forms of K1-K5b,
    # the f32 generation those of K1-K4, its int8 one K7/f32 and f32
    # training on the split routes those of K6, K8a and K8b; the line adds
    # the nineteen runs (phases inpaint and modalities: K1-K4 too;
    # train-coco: mixed-precision training's kernels, through the loader;
    # parallel: the ranks' runs, K1-K4, K2 also as its split pair;
    # train-dp: the ranks' f32 training runs, the f32 forms of K1-K5b)
    runs = {"generate": gen_counts, "fast": fast_counts, "int8": int8_counts,
            "routes": routes_counts, "inpaint": inpaint_counts,
            "modalities": modal_counts, "bench": bench_counts, "cli": cli_counts,
            "rl": rl_counts, "eval": eval_counts, "preview": preview_counts,
            "train": train_counts[""], "train-coco": coco_counts,
            "train-f32": train_counts["-f32"], "generate-f32": gen_f32_counts,
            "int8-f32": int8_f32_counts, "routes-f32": routes_f32_counts,
            "parallel": parallel_counts, "train-dp": train_dp_counts,
            **geometry_counts, "train-hires": train_hires_counts}
    counts = {kid: sum(c[kid] for c in runs.values()) for kid in KERNEL_META}
    generation = ("K1", "K2", "K3", "K4")
    encoders = ("K1/f32", "K2/f32", "K3/f32")
    expected = {"generate": generation, "fast": generation, "int8": ("K7",),
                "routes": ("K6", "K8a", "K8b"), "inpaint": generation,
                "modalities": generation, "bench": generation,
                "cli": generation, "rl": generation + ("K3/f32",),
                "eval": EVAL_KIDS, "preview": PREVIEW_KIDS,
                "train": step_kernels(DEFAULT) + encoders,
                "train-coco": COCO_KIDS,
                "train-f32": tuple(f"{kid}/f32" for kid in step_kernels(DEFAULT)),
                "generate-f32": tuple(f"{kid}/f32" for kid in generation),
                "int8-f32": ("K7/f32",),
                "routes-f32": ("K6/f32", "K8a/f32", "K8b/f32"),
                "parallel": generation,
                "train-dp": tuple(f"{kid}/f32" for kid in step_kernels(DEFAULT)),
                "hires": generation + tuple(f"{kid}/f32" for kid in generation),
                "heads5": generation + tuple(f"{kid}/f32" for kid in generation),
                "heads1": generation + tuple(f"{kid}/f32" for kid in generation),
                "hires1": generation + tuple(f"{kid}/f32" for kid in generation),
                "train-hires": step_kernels(DEFAULT) + tuple(
                    f"{kid}/f32" for kid in step_kernels(DEFAULT))}
    missing = [f"{kid} ({path})" for path, kids in expected.items()
               for kid in kids if runs[path][kid] <= 0]
    line = []
    for kid, (name, src, replaces) in KERNEL_META.items():
        s = summary[kid]
        line.append({"name": f"{kid} {name}", "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[kid],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": ("operations" if s["ops_ms"] >= s["bytes_ms"]
                                  else "bytes"),
                     "library_ms": s["library_ms"], "device_ms": s["device_ms"],
                     "library_device_ms": s["library_device_ms"],
                     "host_us_median": host_us_median(s), "shapes": s["shapes"]})
        base = kid.split("/")[0]
        if base in VS_LIBRARY_KIDS:
            line[-1]["vs_library"] = s["ms"] / s["library_ms"]
            line[-1]["device_vs_library"] = (s["device_ms"]
                                             / s["library_device_ms"])
        if kid == "K2":
            line[-1]["unet_eval_device_ms"] = unet_eval_device_ms(
                unet_cfg, tok_len, s["device_ms_by_args"])
            # the split pair ('spatial' TP): its rows' sums, its launches
            line[-1]["split"] = {**s.get("split", {}),
                                 "launches": parallel_counts["K2 split"]}
        if base in ("K5a", "K5b"):
            line[-1]["pair"] = k5_pairs["f32" if kid != base else "bf16"]
        if "by_width" in s:
            line[-1]["by_width"] = {str(w): rec for w, rec in sorted(s["by_width"].items())}
        if kid != base:
            line[-1]["arith"] = F32_ARITH[base]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if missing:
        print(f"chip_smoke: FAILED: no launches of {missing} on the main path",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
