#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tango_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --detail   # also one line per kernel shape

Phases, one short JSON line each:
  device   the card's name and power limit;
  build    nvcc of tango_tpu_torch/csrc/*.cu into build/ (or the cached library),
           one nvcc per source, all started together, then one link;
  ingest   audio ingestion on the host: in a child process with one BLAS
           thread, each fixture of tests/data/ingest/ (FLAC, MPEG-1 Layer III,
           Ogg Vorbis, Ogg Opus, AIFF; scripts/make_ingest_fixtures.py) read
           INGEST_REPS times through the port's read_wav and held against
           JAX's decode committed beside it (FLAC and AIFF bit-equal, the
           rest within INGEST_LIMIT); the decode seconds, the audio seconds
           decoded per wall second and the samples per second by format, the
           FLAC subframes each path decoded (native C or python) and the C
           decoder's build, and whether the system libopus loads (without
           it, validate_manifest must refuse an Opus manifest with
           ValueError, and the train_cli manifest holds no Opus clip);
  model    full-width Tango (TANGO_UNET, FLAN-T5-Large encoder, TANGO_VAE,
           TANGO_HIFIGAN, SD-2.1 DDPM) with seeded random bf16 weights;
  warmup   one 1-step generate (first-use costs of cuDNN and cuBLAS);
  slice, long_clip, long_prompt
           the serving paths, each with launch counters and recorded shapes
           zeroed just before it and read just after, and each with its own
           list of kernels that must have launched (PATH_KERNELS):
           slice: generate("a dog barks", steps=10) and a 3-prompt
           generate_for_batch with batch_size=2 (tail padding);
           long_clip: generate(duration=20.0), 512 latent frames, 8192 tokens
           at the UNet's first level, which take attn_fwd_v2;
           long_prompt: generate with max_text_length = 256, whose masked
           cross-attention takes attn_fwd_bias. Each new path is warmed up
           by one uncounted 1-step generate first. On every serving path
           (these, snapshot, int8, int8_conv) each attn_fwd / attn_fwd_v2 /
           attn_fwd_bias launch is bf16 at head dim 64 and must have taken
           the tensor-core body (tc_launches == launches); on every counted
           path (these, snapshot, int8, int8_conv and train) each gn_silu_fwd
           launch must have taken its thread-block-cluster body
           (cluster_launches == launches);
  snapshot, snapshot_cli
           between slice and long_clip: the slice pipeline's weights written
           as a full-width reference-format snapshot under build/ (the main
           bin through the port's save_main_bin, f32 under the reference's
           names; the VAE decoder and the vocoder, weight-normed, under
           AudioLDM's; main, vae (with a ddconfig block), unet and stft
           configs), its bytes and write seconds; Tango(dir) on the card in
           bf16 with the default tokenizer (which must warn) and
           cast_params=True, its cold start in seconds; every UNet, T5 and
           VAE parameter bit-equal to the slice pipeline's and every vocoder
           parameter within one bf16 step (the weight-norm fold; the count
           that differ logged); then path `snapshot`, counted:
           generate("a dog barks", steps=10, seed=0) with the serving path's
           kernels (PATH_KERNELS, the tensor-core and cluster bodies), its
           final latents equal to the slice's first at the same seed (max
           abs difference 0), the waveform's largest int16 difference
           logged; then, uncounted, `python -m tango_tpu_torch.inference`'s
           main on the snapshot (3 prompts, 2 steps, batch 2), which must
           write three non-silent 163872-sample int16 WAVs and one
           summary.jsonl record; the pipeline freed, the phase's seconds
           and the smoke's total_s so far logged. The snapshot's VAE bin
           also holds a seeded random encoder and quant_conv (released
           snapshots ship them; serving skips them, the trainers need them);
  serve_http, train_cli, dpo
           the entry points on the same snapshot, each counted on its own
           (the counters zeroed just before it and read just after; every
           attention launch on its tensor-core body, every gn_silu_fwd and
           gn_silu_bwd on its cluster body), the directory deleted after:
           serve_http: serve.BatchingPredictor(max_batch=4) set up on the
           snapshot (bf16; the load and the two warm-ups timed) behind
           serve_http on 127.0.0.1 at port 0; GET /healthz; 4 concurrent
           unseeded POST /generate at STEPS steps, which must ride one
           predict_batch and one generate_for_batch of batch 4; one seeded
           request, whose WAV must equal generate at that seed sample for
           sample; two bad bodies, 400; every response a non-silent 16 kHz
           mono int16 WAV of the clip's length; the latencies logged.
           train_cli: train/cli.py's main on a manifest of 8 clips, one
           each of FLAC, mp3, Ogg Vorbis, AIFF and (where libopus loads)
           Ogg Opus, copies of the ingest fixtures, and synthetic WAVs for
           the rest (--tango_snapshot and --hf_model the snapshot, batch 2,
           accumulation 2, 2 updates, one epoch, best): the args and one
           epoch record with finite losses, `best` with the UNet's keys and
           not the snapshot's weights, every clip decoded by its format's
           decoder (none replaced by the loader's constant stand-in), the
           micro-steps' ms, the seconds the trainer waited on each batch of
           the loader (loader_wait_s) and the peak memory logged.
           dpo: train/dpo_cli.py's main on a 4-row preference manifest (batch 2, accumulation 1, 2 epochs, 1 of them SFT-first,
           a 2-row validation file): one sft and one dpo record with finite
           losses and implicit_acc in [0, 1], `last` and `best`, the
           reference UNet bit-equal to the snapshot's after the run, the ms
           a DPO and an SFT micro-step and the peak memory logged;
  tango2_eval
           on the same snapshot, counted as one path: seeded random
           full-width scorers written in their released formats (a
           LAION-CLAP .pt of RoBERTa-base, HTSAT-tiny and both projections,
           the audio side under `module.`; Cnn14 as {"model": sd}; VGGish),
           each converting back bit-equal, and 4 reference WAVs;
           inference_tango2.main with --clap_ckpt, --reference_dir,
           --cnn14_ckpt and --vggish_ckpt (4 prompts, STEPS steps, batch 4,
           the RoBERTa-id fallback tokenizer, which must warn), then
           inference.main with --num_samples 2 --clap_ckpt (batch 2). The
           record must have JAX's keys (TANGO2_RECORD_KEYS, METRIC_KEYS), a
           finite CLAP score in [-1, 1] and finite metrics but IS (NaN below
           10 clips, as in JAX); every tower's weights on the card; each
           re-ranked WAV its group's argmax of the CLAP similarity recomputed
           here; every attention launch on its tensor-core body and every
           gn_silu_fwd on its cluster body. Then, uncounted, the full-width
           text and audio embeddings, HTSAT's latent map, Cnn14's `2048` and
           `logits` and VGGish's embeddings on the card against the same
           modules on the CPU in f32 (CARD_CPU_LIMITS). The seconds of each CLI, the loads,
           the checkpoints' bytes, the peak memory, the metrics and the
           errors logged;
  mesh     after tango2_eval, on the same snapshot (MESH_* bounds): the
           port's device mesh with its ranks as processes that share the one
           card over gloo (parallel.launch, torchrun's variables, a free
           port), this process's cache freed first. One-process references
           first: this pipeline's latents for MESH_PROMPTS at MESH_SEED, the
           ms of a bf16 UNet step at CFG batch 2, and a full-width f32
           SFT (remat, uncondition) at batch 2 for MESH_DP_UPDATES (1) update
           on seeded WAVs, its losses and parameters. (a) TP = 2: each rank holds the
           snapshot's f32 UNet, evaluates it at batch 1 whole, shards it and
           evaluates again (within MESH_F32_LIMIT of the largest magnitude),
           both with TF32 convolutions and in f32 convolutions,
           then Tango(dir, mesh=make_mesh(data=1, model=2)) in bf16:
           generate_for_batch of the 4 prompts, MESH_TP_STEPS (4) steps, CFG, whose latents
           must be within MESH_TP_REL_L2 of one process's, and the ms a step
           at CFG batch 2 (batch 8 is not timed apart, for time: the
           generate_for_batch above runs at it); (b) DP = 2: SFTTrainer(mesh=) at batch 1 a
           rank on the same global batches, its losses within
           MESH_LOSS_RTOL and every parameter within MESH_PARAM_LR_FACTOR lr
           (both runs' convolutions without TF32)
           of one process's, the ms an update and the all-reduce's share;
           (c) dryrun_multichip(4), the 2 x 2 DP x TP and DP x SP steps of
           the dry run's tiny config against its meshless step (its record
           in the line, `sp_loss`, `sp_param_max_drift`); (d) SP = 2 (line
           `mesh_sp`): sequence parallelism over the long clip's 512
           latent frames (8192 first-level tokens), each rank with the
           snapshot's UNet replicated: an f32 evaluation at batch 1 with
           latent_sharder=partial(shard_latents_seq, mesh=mesh) against the
           rank's meshless one (MESH_SP_F32_LIMIT in f32 convolutions,
           MESH_F32_LIMIT with TF32), then in bf16
           AudioDiffusion(latent_sharder=)'s sample of PROMPT, MESH_SP_STEPS
           DDPM steps at CFG batch 2 at MESH_SEED, within MESH_TP_REL_L2 of
           this process's; both ranks' outputs bit-equal; the ms a step
           beside one process's, each evaluation's collectives by kind (halo,
           group_norm, kv, output) and the bytes a rank received; then (line
           `mesh_sp_int8`) each rank's UNet quantized (scope "all", as
           Tango.from_components(quant="all") serves it: the f32 weights
           quantized, the rest bf16) and evaluated at CFG batch 2 over the
           same 512 frames without a mesh and with the latent sharder:
           the SP output finite, each int8 convolution path (3x3, 1x1
           shortcut, down- and upsampler) at its full-width shape bit-equal
           to the meshless layer and, with each slab quantized by its own
           amax (the control), not bit-equal, both ranks' outputs
           bit-equal, one `int8_amax` all-reduce for each QConv2d; the
           relative L2 of the SP output and the control's from the
           meshless one (read, not held: both sit at the int8 mode's own
           noise); the ms of the evaluation (first and warm)
           beside the meshless one's, its collectives and bytes by kind, the
           W8A8 GEMMs' (M, K, N); then (line
           `mesh_sp_train`) an SP = 2 training step: the snapshot's f32 UNet
           in SFTTrainer(mesh=) with the latent sharder (remat, min-SNR 5,
           batch 1 at the long clip's 512 latent frames, accumulation 1, one
           AdamW update, f32 convolutions), which rank 0 holds to the same
           step without a mesh: the loss within MESH_LOSS_RTOL, the
           gradients' relative L2 within MESH_SP_GRAD_REL_L2, every updated
           parameter within MESH_PARAM_LR_FACTOR lr; both ranks' losses
           equal; the ms of the step beside the meshless one's, its
           collectives and bytes by kind (the backward's "<kind>_grad"), the
           ranks' peak memory. Each rank zeroes its counters before its
           counted work and saves its launches, shapes and bodies; the sums
           of (a)-(c) are path `mesh` (PATH_KERNELS["mesh"]), (d)'s
           evaluations path `sp` (PATH_KERNELS["sp"]: gn_stats, gn_apply,
           attn_fwd at the slabs' queries against every key, attn_fwd_v2; no
           gn_silu_fwd), its int8 evaluation path `sp_int8` (w8a8_matmul and
           those four; no gn_silu_fwd; every w8a8_matmul launch on its
           tensor-core body), its training step path `sp_train` (those four,
           gn_bwd_stats, gn_bwd_apply, attn_bwd_dq and attn_bwd_dkv at the
           slabs' queries against every key; no gn_silu_bwd, and
           gn_silu_fwd only in the frozen VAE encoder); on each every
           attention launch on its tensor-core body, every GroupNorm on its
           cluster body (gn_bwd_apply: its flat body, flat_launches ==
           launches); peak memory and
           launches per rank logged, with the card's name and power limit;
  mustango_build, mustango, mustango_beam_loops, mustango_predictors,
  mustango_cli
           after the Tango snapshot is deleted (free disk checked first):
           the full-width Mustango (TANGO_UNET's geometry with the `*Music`
           blocks, two extra 1024-wide streams; FLAN-T5-Large, TANGO_VAE,
           TANGO_HIFIGAN, the music conditioner, DeBERTa-v3-large and an
           untied FLAN-T5-large seq2seq) from seeded random weights,
           written in the released layout under build/ (configs/, vae/,
           ldm/ through save_ldm_bin, beats/, chords/; ~12.3 GB), its bytes
           and seconds; Mustango(dir) in bf16 (the predictors f32), its
           cold start, every weight equal to the written one (the vocoder
           within one bf16 step), the three tokenizer fallbacks warned; one
           UNet evaluation of each pipeline, whose attn_fwd launches must
           be 3x Tango's; then path `mustango`, counted: generate of
           MUSTANGO_PROMPTS[0] with both predictors (DeBERTa's beats, the
           5-beam search's chords on its default, the device loop replayed
           as a CUDA graph: its steps and host syncs logged beside the
           predictors' seconds), generate_for_batch of the 4 prompts at
           batch 4 with explicit features (MUSTANGO_BEATS, MUSTANGO_CHORDS)
           and generate of the first with them, whose latents the batch's
           row 0 must match within MUSTANGO_ROW0_REL_L2; every attn_fwd on
           its tensor-core body, every gn_silu_fwd on its cluster body,
           163872-sample non-silent int16 waveforms; then, uncounted, the
           chord search on the card again as the graphed device loop (the
           same tokens), the eager device loop and the host loop, each timed
           (mustango_beam_loops: the device loop's tokens equal the host
           loop's, or differ at a near-tie of f32 against f64 scores that
           first_divergence finds on the eager loop's log-probabilities);
           the predictors on the card against the same modules on the CPU
           in f32 (DeBERTa's logits and intervals, T5's first-step
           log-probabilities within PREDICTOR_LIMITS; the host loop's beam
           tokens equal, or at the first step whose ranking differs the
           CPU's margin between the two candidates within twice their
           card-vs-CPU difference, logged);
           convert_cli export-mustango of the snapshot reloaded bit-equal;
           serve.main --music at 2 steps once; the directory deleted;
  audioldm_build, audioldm, audioldm_cli
           after mustango: the full-width AudioLDM-S (AUDIOLDM_S_UNET, 185M;
           TANGO_VAE with its encoder; the weight-normed TANGO_HIFIGAN;
           RoBERTa-base and HTSAT-tiny CLAP with both projections) written
           from seeded random f32 weights as one monolithic checkpoint in the
           released layout under build/ (~1.8 GB; every part converting back
           bit-equal, the vocoder within f32 rounding), its bytes and
           seconds; build_model(ckpt) in f32 with the port's RoBERTa
           word-hash tokenizer, so the native CLAP conditions, the load
           timed, every weight equal to the written one; one UNet
           evaluation at CFG batch 6, which must launch AUDIOLDM_PER_EVAL
           (20 attn_fwd at head dim 32, 61 gn_silu_fwd, no two-stage
           GroupNorm); the device time of one evaluation at CFG batch 6
           (torch.profiler: the kernels' own time) and attn_fwd's share of
           it, and the same evaluation with every attn_fwd call on the
           CUDA-core body (tt_attn_fwd_core) beside it, both uncounted;
           then path `audioldm`, counted: text_to_audio at 10 s,
           STEPS DDIM steps, 3 candidates (CFG batch 6), guidance 2.5, whose
           output must be the candidate of the largest CLAP similarity, the
           ms a DDIM step logged; style_transfer of a written 10 s WAV at
           strength 0.5 (the last 3 latent frames dropped: 161952 samples);
           super_resolution_and_inpainting, whose final latents must equal
           the source's outside the mask. Every attn_fwd launch on the
           tensor-core body (head dim 32, the static form, f32 on 3xTF32),
           20 an evaluation; every gn_silu_fwd on the cluster body. Then,
           uncounted: one FiLM UNet evaluation at batch 1 and one DDIM step
           (eta 0) on the card against the same on the CPU, f32, within
           AUDIOLDM_CARD_CPU_LIMIT of the CPU output's largest magnitude;
           `python -m tango_tpu_torch.audioldm` once in a subprocess (2
           steps, 2 candidates), which must write one non-silent 163872-
           sample WAV; the directory deleted. The kernels phase checks and
           times the D = 32 attention shapes with the rest (`d32` in
           attn_fwd's field: their own totals by type, the tensor-core body
           beside the CUDA-core one, tt_attn_fwd_core, at the same shapes);
  int8     the int8 W8A8 serving mode: a full-width Tango.from_components(
           quant="all") built from the bf16 model's state dicts (the same
           weights, quantized once on the card), one uncounted 1-step
           warm-up, then a counted generate("a dog barks", steps=10) at CFG
           batch 2 (PATH_KERNELS["int8"], w8a8_matmul included) with its UNet
           step time, w8a8 launches per evaluation and the relative L2 of
           its final latents against the bf16 slice's at the same seed;
           every w8a8_matmul launch (K % 16 == 0 at every int8 shape) must
           have taken the tensor-core body (tc_launches == launches);
  int8_conv
           an uncounted 2-step generate with quant="conv" (the JAX bench's
           default scope: int8 convolutions on torch._int_mm), which must
           launch no w8a8_matmul;
  int8_order
           the int8 quantize order (cast_params), uncounted: from one seeded
           f32 UNet, quant="all" with cast_params False (JAX's
           from_components: the f32 weights quantized) and True (cast to
           bf16 first); the int8 weights and scales that differ, and the
           relative L2 between one 2-step generate's latents in each order;
  per_eval launches of each kernel in one UNet evaluation, bf16 and int8
           (w8a8_matmul once for every quantized Linear: 16 transformers x 9
           projections, each on the tensor-core body), the device time of
           one evaluation of each (torch.profiler: the kernels' own time,
           no host gaps) with the int8 one's W8A8 kernels and the (M, K, N)
           of its GEMMs, and the 3x3 stride-1 convolution shapes of the bf16
           evaluation, recorded by forward hooks, for winograd_conv3x3, which
           no path calls (in JAX neither);
  trace    the bf16 evaluation once more inside
           tango_tpu_torch.utils.profiling.trace (a torch.profiler chrome
           trace under build/, read back and deleted): its CUDA kernel
           events, and the port's own kernels among them by name (the
           __global__ functions of csrc/*.cu), which must number the
           evaluation's wrapper launches;
  demo_torch
           `python examples/demo_torch.py --tiny` on the card in a child
           process in an empty directory under build/: exit 0 and a 16 kHz,
           non-silent demo_tiny.wav;
  train_model, train
           the training path: full-width f32 SFT (TANGO_UNET with remat,
           min-SNR 5, uncondition dropout; the TANGO_VAE encoder and the
           FLAN-T5-Large encoder frozen; seeded random weights) on 8 seeded
           synthetic 10.24 s WAVs written under build/: SFTTrainer.fit with
           batch 2, accumulation 2 and max_train_steps 2 (4 micro-steps), one
           validation batch, the best checkpoint loaded back bit-equal and
           deleted. Counters zeroed just before fit and read just after: the
           seven kernels of training, forward and backward, must have
           launched; every f32 attn_fwd (3xTF32), attn_bwd_dq and attn_bwd_dkv
           launch (head dim 64) must have taken its tensor-core body
           (tc_launches == launches), and every gn_silu_fwd and gn_silu_bwd
           launch its thread-block-cluster body (cluster_launches ==
           launches). Every
           loss must be finite, and
           the parameters must change after the 2nd and 4th micro-step only;
  kernels  every kernel against its plain PyTorch version at every shape
           any path launched it at, in f32 and bf16. Forward kernels: f32
           atol 2e-5, rtol 1e-4 (the stats partial sums rtol 1e-4 alone),
           bf16 GroupNorm atol 2e-2, rtol 2e-2 and attention atol 4e-3, rtol
           1e-2, plus the attention extreme-logit cases (the static-shift
           window and its underflow row; v2 past the window) and a fully
           masked batch row for the bias kernel (f32 atol 1e-3 on that row).
           At head dim 64 the forward kernels run tensor-core bodies, all
           three in bf16 and in f32 (3xTF32), and attn_fwd at head dim 32
           too. Every call is checked at every launched shape and must take
           the body `tc_body` names for its form; the
           tensor-core bodies also at ragged shapes and one 128 x 128 tile
           (TC_SHAPES, in both types) and the biased one at a ragged shape
           with one bias row and with a row a query (BIAS_TC_SHAPES); a
           misaligned view where a tensor-core body runs must raise; both
           types are timed (f32 in the `f32` field), attn_fwd_bias too. f32
           attn_fwd at the training shapes and at AudioLDM's head-dim-32
           ones, f32 attn_fwd_v2 at the long
           clip's and f32 attn_fwd_bias at the long prompt's (with a padding
           bias that leaves a quarter of the keys open), with q and k at
           amplitude 3, from two seeds, are held against float64 at 2e-5 /
           1e-4 (phase `fwd_amplitude` logs each one's and its plain
           version's share of the limits).
           Backward kernels: f32 attention atol 1e-4, rtol 1e-3 and GroupNorm
           atol 2e-4, rtol 1e-3, bf16 attention 4e-3 / 1e-2 and GroupNorm
           2e-2 / 2e-2, lse and delta 1e-4 / 1e-3. attn_bwd_dq and
           attn_bwd_dkv run their tensor-core body in f32 and bf16 at head
           dim 64: also checked at a ragged shape (BWD_TC_RAGGED), with q and
           k at amplitude 3 in f32 at the training shapes, in two draws (dq,
           dk, dv against the plain versions and against the same formula in
           float64, at 1e-4 / 1e-3; lse and delta against float64 only:
           there the plain versions' own f32 error reaches ~0.65 of that
           limit; phase `bwd_amplitude` logs all three distances' shares
           and the max-abs and max-rel differences), and against a
           misaligned view, which must raise. gn_silu_fwd at every launched
           shape and gn_silu_bwd at every training shape, in both types,
           each call held to the body `gn_fwd_cluster_size` /
           `gn_bwd_cluster_size` names (all of them the cluster body;
           --detail rows carry each launch's cluster size and CTAs), and
           their streaming bodies at GN_FWD_STREAMING / GN_BWD_STREAMING,
           checked only; gn_bwd_stats and gn_bwd_apply (path sp_train's
           split GroupNorm backward) at the slabs' shapes in both types,
           each call held to its body (gn_bwd_stats' cluster body by
           `gn_bwd_stats_cluster_size`, gn_bwd_apply's flat body), against
           their plain versions at the GroupNorm backward's limits, timed
           beside aten's GroupNorm backward of the slab and beside their
           streaming fallbacks (the bodies they replaced, through the _rows
           entry points, with the zeroed tickets they take: `parent_ms`,
           also checked there), --detail rows with the cluster size and CTAs
           (stats) and packets a thread and CTAs (apply); the fallbacks
           through the wrappers at GN_SPLIT_STREAMING, checked only; line
           `kernels_sp_train` sums path sp_train's own shapes, the backward
           pair at its Sq < Skv ones among them;
           gn_silu_fwd's host time per call at HOST_US_SHAPE
           (1000 back-to-back calls, `host_us_per_call`). Then
           one shape past each of the wrappers' old launch limits (LIMIT_*),
           checked, not timed; its gn_silu_fwd and gn_silu_bwd also held to
           their rules.
           Kernel, plain and library device times per call (bf16 inputs, and
           f32 as well for the GroupNorm kernels and the backward kernels;
           10 calls captured in a CUDA graph, median of 10 replays between
           CUDA events; the plain versions 2 calls, 5 replays), summed over the
           kernel's shapes (--detail: per shape, with TFLOP/s for the
           attention kernels and each shape's share of its bound). The
           library yardsticks: F.group_norm(+F.silu),
           sdpa (with a float mask for the bias kernel), and for the
           backward kernels aten's GroupNorm (and SiLU) backward and the
           attention backward kernels sdpa's autograd runs, called directly.
           w8a8_matmul at every shape the int8 path launched it at and at
           tests/test_quant.py's (300, 320) x (320, 256) (the tensor-core
           body: quantize pass plus s8 wgmma GEMM, timed together), two
           ragged shapes (K % 16 != 0: the __dp4a body) and three ragged
           ones of the tensor-core body (W8A8_TC_RAGGED), checked only: f32
           atol 1e-5 / rtol 1e-5 (the JAX test's), bf16 one bf16 step (1e-2
           / 8e-3); library torch._int_mm on the pre-quantized operands,
           and bf16 F.linear as a note (--detail: per shape, with TOP/s);
           timed in f32 too (the `f32` field); line `kernels_sp_int8` sums
           path sp_int8's own W8A8 shapes (the slabs' token counts).
           winograd_conv3x3, called directly, at tests/test_winograd.py's
           shapes and at the hooked UNet shapes: both types on the
           tensor-core body (bf16 wgmma, f32 3xTF32), also at a ragged
           shape (WINO_TC_RAGGED, checked only); f32 1e-4 / 1e-4 (the JAX
           test's), bf16 2e-2 / 2e-2; timed as the whole wrapper and, in
           bf16, as the kernel alone, and in f32 beside cuDNN without TF32
           (the `f32` field) (kernel_only_ms: `launch` on a prepared U; with
           --detail both kernels' rows also split one call's device time by
           kernel, `by_kernel_ms`, from torch.profiler), its U kernel
           (`weight_tc`) held within one bf16 step of the torch U in bf16, a
           few ulps in f32; library F.conv2d (cuDNN). Every call of both
           must take the body its rule names. Bounds: int8 operations over 1979 TOP/s or
           bytes; Winograd's 4 multiply-adds an output per input channel
           over the bf16 (or f32) peak, or bytes. f32 attention, forward and
           backward, is bounded at the least the tensor cores can do it in
           within JAX's f32 limits (attn_bound_ms): every product as 3xTF32,
           a third of TF32's rate (so is f32 Winograd); GroupNorm by bytes.
The last three lines are the card's `nvidia-smi` name and power limit, the
`kernels` JSON, and the result line. Any failure exits non-zero before the
result line; so does a card-less machine. The script writes nothing but
build/ (the kernel library, and the snapshot, the training data and
checkpoints, which it deletes) and stops itself after 720 s.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import faulthandler
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import torch
import torch.nn.functional as F

DEADLINE_S = 720
# phase mesh: (a) TP = 2 serving of MESH_PROMPTS at MESH_SEED, its latents within
# MESH_TP_REL_L2 (relative L2) of one process's (the row-parallel partial sums
# change the order of summation; Mustango's row-0 bound) and an f32 UNet
# evaluation within MESH_F32_LIMIT of the largest output magnitude (the
# card-vs-CPU bound of AudioLDM's phase), with TF32 and with f32 convolutions;
# (b) DP = 2 f32 SFT at MESH_DP_BATCH / 2
# rows a rank for MESH_DP_UPDATES updates against one process at MESH_DP_BATCH,
# its convolutions in f32 too (`f32_convolutions`): losses within
# MESH_LOSS_RTOL, every parameter within MESH_PARAM_LR_FACTOR lr (JAX's Adam
# amplification bound, tests/test_parallel.py:162-171); (d) SP = 2 over the
# long clip's latents: an f32 UNet evaluation within MESH_SP_F32_LIMIT of the
# rank's meshless one's largest magnitude in f32 convolutions (only two-part
# sums are reordered) and within MESH_F32_LIMIT with TF32 ones, and a bf16
# AudioDiffusion(latent_sharder=) sample of MESH_SP_STEPS DDPM steps at CFG
# batch 2 within MESH_TP_REL_L2 of one process's; each launch of ranks within
# MESH_LAUNCH_TIMEOUT_S
MESH_PROMPTS = ["a dog barks", "rain on a tin roof", "an engine idles", "birds sing"]
MESH_SEED = 11
MESH_TP_STEPS = 4  # (a)'s DDPM steps: fewer than STEPS, for the smoke's time limit
MESH_TP_REL_L2 = 0.05
MESH_F32_LIMIT = 2.5e-2
MESH_DP_BATCH = 2
MESH_DP_UPDATES = 1
MESH_LOSS_RTOL = 1e-3
MESH_PARAM_LR_FACTOR = 2.5
MESH_LAUNCH_TIMEOUT_S = 300
MESH_TARGET_LENGTH = 1024  # fbank frames of (b)'s clips: 10.24 s, 256 latent frames
MESH_SP_F32_LIMIT = 1e-4
MESH_SP_STEPS = 2
# (d)'s SP = 2 f32 training step against the same step without a mesh: the
# gradients' relative L2 over every parameter (only the slabs' two-part sums
# and the attention backward's key split are reordered, in f32 convolutions);
# the loss within MESH_LOSS_RTOL, each updated parameter within
# MESH_PARAM_LR_FACTOR lr, as (b)
MESH_SP_GRAD_REL_L2 = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# the softmax's exp2 on the multi-function units: 16 a clock an SM (sm_90),
# 132 SMs at 1.98 GHz; the floor of attention at head dim 32, one exp2 a logit
EX2_PER_S = 16 * 132 * 1.98e9
BF16_FLOPS = 989e12         # dense tensor-core bf16
INT8_OPS = 1979e12          # dense tensor-core int8
F32_FLOPS = 67e12           # f32 outside the tensor cores
TF32_FLOPS = 495e12         # dense tensor-core TF32
# f32 products within f32's accuracy, the least the card can do them with:
# 3xTF32, three TF32 products each, the scheme the f32 attention bodies run
# for every product (S = Q K^T, dP = dO V^T, P V, dQ, dK, dV; split bf16 missed
# JAX's limits at amplitude 3 on P V and used most of them on dQ, dK, dV);
# also the bound of the f32 Winograd convolution's products
F32_TC_FLOPS = TF32_FLOPS / 3
TRAIN_WAVS = 8
INGEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "ingest")
INGEST_FORMATS = ("flac", "mp3", "ogg", "opus", "aiff")  # clip.<name> in INGEST_DIR
INGEST_EXACT = ("flac", "aiff")  # bit-equal to JAX's decode; the rest within INGEST_LIMIT
INGEST_LIMIT = 1 / 32768  # one int16 step: numpy may sum in another order here than there
INGEST_REPS = 3
TRAIN_BATCH = 2
TRAIN_CAPTIONS = ["a dog barks", "rain on a tin roof", "an engine idles", "birds sing"]
PROMPT = "a dog barks"
BATCH_PROMPTS = ["a dog barks", "rain on a tin roof", "an engine idles"]
STEPS = 10
DEVICE = "cuda"
# 20.0 s -> 512 latent frames (25.6 a second, a multiple of 8): 8192 tokens at
# the UNet's first level, over 4096 and a multiple of 512, JAX's rule for the
# blocked-KV kernel. (20.48 s would give 528 frames, 8448 tokens: not a
# multiple of 512, so the static-shift kernel, in JAX as here.)
LONG_CLIP_S = 20.0
LONG_PROMPT_TOKENS = 256
# shapes past the wrappers' old launch limits (phase `kernels`): the UNet's
# two-stage GroupNorm site at 35 prompts (CFG batch 70), past grid.y's 65535
# rows; a GroupNorm of 2^31 elements, the VAE decoder's (B, 128, 1024, 64)
# site at B = 256; attention over 70000 heads, past grid.y's 65535, at head dim 8
LIMIT_ROWS_SHAPE = (70, 960, 256, 16)
LIMIT_GN_SHAPE = (256, 128, 1024, 64)
LIMIT_HEADS = 70000
# gn_silu_fwd's host cost per call: a small bf16 map (the UNet's last level
# at CFG batch 2), where the card is quicker than the host
HOST_US_SHAPE = (2, 1280, 8, 8)
# ragged shapes and one tile for the tensor-core attention body, checked
# only: ((BH, Sq, D), (BH, Skv, D)) for attn_fwd and attn_fwd_v2; attn_fwd's
# also at head dim 32 (AudioLDM's): 200 queries, 333 keys (a last tile of 77
# in bf16, 13 in f32)
TC_SHAPES = {
    "attn_fwd": (((3, 200, 64), (3, 333, 64)), ((1, 128, 64), (1, 128, 64)),
                 ((6, 200, 32), (6, 333, 32))),
    "attn_fwd_v2": (((2, 8320, 64), (2, 8320, 64)), ((1, 128, 64), (1, 128, 64))),
}
# the backward's tensor-core body (f32 and bf16 at D = 64), checked only: a
# ragged shape ((BH, Sq, D), (BH, Skv, D)), and the amplitude of q and k in
# its large-logit case, drawn from each of two seeds
BWD_TC_RAGGED = ((3, 200, 64), (3, 333, 64))
BWD_TC_AMPLITUDE = 3.0
BWD_TC_AMPLITUDE_SEEDS = (31, 32)
# the same large-logit case for the f32 forward's tensor-core body (3xTF32),
# at the training path's shapes against float64
FWD_TC_AMPLITUDE_SEEDS = (31, 32)
# the biased tensor-core body, checked only: ragged (200 queries, 333 keys: a
# last tile of 77) with one bias row a batch row and with a row a query,
# ((BH, Sq, D), (BH, Skv, D), (B, 1 | Sq, Skv))
BIAS_TC_SHAPES = [((6, 200, 64), (6, 333, 64), (2, 1, 333)),
                  ((6, 200, 64), (6, 333, 64), (2, 200, 333))]
# the serving paths: every attention kernel launch there is bf16 at D = 64,
# or (audioldm) f32 attn_fwd at D = 32, and takes the tensor-core body
TC_PATHS = ("serve", "snapshot", "serve_http", "long_clip", "long_prompt", "int8", "int8_conv",
            "mustango", "audioldm", "sp", "sp_int8")
# paths whose attention runs the CUDA-core body (csrc/attention.cu): none.
# AudioLDM's FiLM UNet, heads of 32 (num_head_channels), was one until
# attn_fwd's static form took a tensor-core body at head dim 32; every path's
# attention launches must take the tensor-core body (tc_problems)
CORE_ATTN_PATHS = ()
# the kernels each counted path must launch
PATH_KERNELS = {
    "serve": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd"),
    "long_clip": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "attn_fwd_v2"),
    "long_prompt": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "attn_fwd_bias"),
    "train": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "attn_bwd_dq",
              "attn_bwd_dkv", "gn_silu_bwd"),
    "int8": ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd", "w8a8_matmul"),
}
# a generate from a loaded snapshot runs the serving path's kernels
PATH_KERNELS["snapshot"] = PATH_KERNELS["serve"]
# phase mesh's ranks serve (a) and train (b): the training path's kernels
PATH_KERNELS["mesh"] = PATH_KERNELS["train"]
# phase mesh (d), sequence parallelism over the long clip: every GroupNorm on
# the two-stage kernels (statistics across slabs), the slabs' queries against
# every key at levels 1-2 (attn_fwd) and 0 (attn_fwd_v2); SP_IDLE_KERNELS never
PATH_KERNELS["sp"] = ("gn_stats", "gn_apply", "attn_fwd", "attn_fwd_v2")
SP_IDLE_KERNELS = ("gn_silu_fwd",)
# its training step: the forward's four, the GroupNorm backward split at its
# group sums (gn_bwd_stats, the sums all-reduced, gn_bwd_apply) and the
# attention backward at the slabs' queries against every key; never the
# single-pass GroupNorm backward (gn_silu_fwd runs there only in the frozen
# VAE encoder, which is no part of SP)
PATH_KERNELS["sp_train"] = PATH_KERNELS["sp"] + ("gn_bwd_stats", "gn_bwd_apply", "attn_bwd_dq",
                                                 "attn_bwd_dkv")
SP_TRAIN_IDLE_KERNELS = ("gn_silu_bwd",)
# (d)'s int8 evaluation: the SP path's four, and w8a8_matmul for every
# quantized Linear (per token: local to a slab; K % 16 == 0 at every shape,
# so every launch on its tensor-core body); the int8 convolutions are
# im2col + torch._int_mm (XLA in JAX: no hand kernel), their amax all-reduced
PATH_KERNELS["sp_int8"] = ("w8a8_matmul",) + PATH_KERNELS["sp"]
# the snapshot phase's batch-generation CLI run over BATCH_PROMPTS: steps, batch size
CLI_STEPS = 2
CLI_BATCH = 2
# phase serve_http: BatchingPredictor's batch, the concurrent unseeded
# requests (one batch of them), the seed of the request served alone
SERVE_BATCH = 4
SERVE_PROMPTS = ["a dog barks", "rain on a tin roof", "an engine idles", "birds sing"]
SERVE_SEED = 7
# the training CLIs run the training path's kernels: train/cli.py (SFT) and
# train/dpo_cli.py (DPO: the policy and the frozen reference UNet)
PATH_KERNELS["serve_http"] = PATH_KERNELS["serve"]
PATH_KERNELS["train_cli"] = PATH_KERNELS["train"]
PATH_KERNELS["dpo"] = PATH_KERNELS["train"]
# phase tango2_eval: Tango 2's CLI over 4 prompts at batch 4 (CFG batch 8),
# the batch CLI's re-ranking of 2 samples a prompt at batch 2; both generate
# through the serving path's kernels
TANGO2_PROMPTS = SERVE_PROMPTS
TANGO2_BATCH = 4
RERANK_SAMPLES = 2
RERANK_BATCH = 2
PATH_KERNELS["tango2_eval"] = PATH_KERNELS["serve"]
# phase mustango: the counted path's prompts (the first one also alone, with
# the predictors and then with the features below), the batch, the explicit
# features (tests/test_pipeline_music.py's: beats at 0.5, 1.0, 1.5 s counted
# 1, 2, 3; Gm, Eb, F7); Mustango's UNet runs the serving path's kernels
MUSTANGO_PROMPTS = ["an upbeat jazz piece with a walking bass line", "a slow sad piano ballad",
                    "a rock guitar riff over drums", "a techno beat with a deep bass"]
MUSTANGO_BATCH = 4
MUSTANGO_BEATS = [[0.5, 1.0, 1.5], [1.0, 2.0, 3.0]]
MUSTANGO_CHORDS = (["Gm", "Eb", "F7"], [0.46, 1.39, 3.16])
PATH_KERNELS["mustango"] = PATH_KERNELS["serve"]
# the batch's row 0 against generate of the same prompt, seed and features:
# the relative L2 of the final latents. Not bit-equal on the card: cuBLAS
# tiles a GEMM of 8 rows otherwise than one of 2, so bf16 roundings differ
# (0.011 on an NVIDIA H100 80GB HBM3 at 700 W); a row with another seed's
# noise is ~1.4 apart, another row's features ~0.1 and more. JAX's
# end-to-end bar for int8 against f32 (relative L2 0.05) separates the two
MUSTANGO_ROW0_REL_L2 = 0.05
# phase audioldm: the full-width AudioLDM-S (AUDIOLDM_S_UNET, TANGO_VAE with
# its encoder, TANGO_HIFIGAN, CLAP of RoBERTa-base and HTSAT-tiny) in f32 from
# a monolithic checkpoint of seeded random weights; text_to_audio of the
# prompt at 10 s (256 latent frames), 3 candidates (CFG batch 6), guidance
# 2.5; style transfer at strength 0.5; inpainting of 10%..15% of the clip;
# the CLI once at 2 steps, 2 candidates. The FiLM UNet's heads are 32 wide:
# its attention runs attn_fwd's tensor-core body at head dim 32
AUDIOLDM_PROMPT = "a hammer is hitting a wooden surface"
AUDIOLDM_SECONDS = 10.0
AUDIOLDM_CANDIDATES = 3
AUDIOLDM_GUIDANCE = 2.5
AUDIOLDM_STRENGTH = 0.5
AUDIOLDM_SCALE = 0.95
AUDIOLDM_CLI_STEPS = 2
AUDIOLDM_CLI_CANDIDATES = 2
PATH_KERNELS["audioldm"] = ("gn_silu_fwd", "gn_stats", "gn_apply", "attn_fwd")
# one FiLM UNet evaluation at 256 latent frames: 20 attentions of 1024 and 256
# tokens on the kernel (the 64-token ones plain, Sq < 256), 61 GroupNorms on
# gn_silu_fwd (44 in the 22 res blocks, 16 transformer pre-norms, the output
# norm), none two-stage
AUDIOLDM_PER_EVAL = {"attn_fwd": 20, "gn_silu_fwd": 61}
# the FiLM UNet on the card against the CPU, f32, as the largest difference
# over the CPU output's largest magnitude. cuDNN runs f32 convolutions in
# TF32 (the default), one rounding of 2^-11 relative of each operand; the
# UNet's longest chain holds 52 convolutions (input, 22 res blocks' 44, 3
# down, 3 up, output), whose errors add at worst: 52 * 2^-11 ~ 2.5e-2; in
# quadrature they give ~3.5e-3 (Cnn14's 12 convolutions read 4.8e-4 on an
# NVIDIA H100 80GB HBM3 at 700 W)
AUDIOLDM_CARD_CPU_LIMIT = 2.5e-2
# the predictors on the card against the CPU, both f32 (matmuls without TF32):
# the largest difference as a share of the CPU output's largest magnitude.
# f32 rounds at 2^-24 ~ 6e-8 a product; a dot product of K terms summed in
# another order differs by ~sqrt(K) of that, 4e-6 at K = 4096; DeBERTa chains
# 24 layers of ~6 products and T5 48 (encoder and decoder), the errors adding
# at worst: 24 * 6 * 4e-6 ~ 6e-4 and twice that
PREDICTOR_LIMITS = {"deberta": 1e-3, "t5_first_step": 2e-3}
# the keys of JAX's Tango 2 record (tango_tpu/inference_tango2.py main, with
# --clap_ckpt and --reference_dir) and of EvaluationHelper's result
TANGO2_RECORD_KEYS = {"model", "num_prompts", "num_steps", "gen_time_s", "x_realtime",
                      "output_dir", "clap_score", "metrics"}
METRIC_KEYS = {"frechet_distance", "frechet_audio_distance", "kl_sigmoid", "kl_softmax", "lsd",
               "psnr", "ssim", "ssim_stft", "is_mean", "is_std", "kid_mean", "kid_std"}
# the scorers on the card against the CPU, both f32. f32 matmuls run without
# TF32 (set below), so the text tower differs at f32 rounding: 1e-4 on its
# unit vectors. f32 convolutions run in TF32 (cuDNN's default), one step
# 2^-10 of an operand: HTSAT has one (the patch embedding) before its f32
# transformer, 5 steps on the unit vectors and of its latent map's largest
# magnitude, 5e-3; Cnn14's 12 and VGGish's 6 chained convolutions, 20 steps
# of the output's largest magnitude, 2e-2
CARD_CPU_LIMITS = {"clap_text": 1e-4, "clap_audio": 5e-3, "htsat": 5e-3, "cnn14": 2e-2,
                   "vggish": 2e-2}
# gn_silu_fwd's streaming body, which every path's shape leaves for the
# cluster body, checked only: a misaligned view (offset one element) of a
# serving shape, a bf16 map whose HW is no whole number of packets, and a
# group too large for 16 CTAs' shared memory (4 MiB of f32); (shape, dtype,
# offset)
GN_FWD_STREAMING = (((2, 320, 256, 16), torch.bfloat16, 1), ((2, 64, 5, 5), torch.bfloat16, 0),
                    ((1, 32, 1024, 1024), torch.float32, 0))
# gn_silu_bwd's streaming body, which every training shape leaves for the
# cluster body, checked only: a group too large for 8 CTAs' shared memory
# (2 MiB of f32 x and g), a misaligned view (offset one element) of a
# training shape, and a bf16 map whose HW is no whole number of packets;
# (shape, dtype, offset)
GN_BWD_STREAMING = (((2, 128, 256, 256), torch.float32, 0), ((2, 320, 256, 16), torch.float32, 1),
                    ((2, 64, 5, 5), torch.bfloat16, 0))
# gn_bwd_stats' and gn_bwd_apply's streaming fallbacks, which every slab of
# path sp_train leaves for the cluster and flat bodies, checked through the
# wrappers: a misaligned view (offset one element) of a level-0 slab, and a
# bf16 map whose HW is no whole number of packets; (shape, groups, dtype,
# offset)
GN_SPLIT_STREAMING = (((1, 320, 256, 16), 32, torch.float32, 1),
                      ((1, 64, 5, 5), 32, torch.bfloat16, 0))
# the JAX tests' shapes: tests/test_quant.py:54-65 (M, K, N) and
# tests/test_winograd.py:21-28, :37-44 (B, H, W, Ci, Co); and ragged GEMMs
# (K not a multiple of 4, M and N not of the 64-wide tiles), checked only
W8A8_TEST_SHAPE = (300, 320, 256)
W8A8_RAGGED = ((37, 70, 24), (5, 3, 8))
# ragged shapes of the tensor-core body (K % 16 == 0), checked only: M and N
# off the 128-wide tiles; rows of y that are not whole 16-byte packets (N =
# 7: the epilogue's direct stores); a split K with N % 4 != 0 (the finishing
# pass one element a thread)
W8A8_TC_RAGGED = ((37, 64, 24), (5, 32, 7), (70, 2560, 6))
WINO_TEST_SHAPES = ((2, 8, 6, 16, 24), (1, 256, 16, 8, 8), (2, 4, 4, 8, 16),
                    (2, 8, 8, 16, 24), (1, 64, 16, 32, 8), (2, 256, 16, 16, 16))
# a ragged shape of the tensor-core Winograd body, checked only: Ci not a
# multiple of 8 (V and U zero-padded to 32 channels), odd Co, a 3 x 4 tile grid
WINO_TC_RAGGED = ((1, 6, 8, 20, 13),)


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, per_graph: int = 10) -> float:
    """Device time of one call of `fn`: `per_graph` calls are captured in a CUDA
    graph, so that no host time (Python, the wrapper's checks, the launch
    itself) falls between them; the median over `reps` replays, each between
    two CUDA events, divided by `per_graph`."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    return statistics.median(times)


def plain_cuda_ms(fn) -> float:
    """cuda_ms of a plain version: 2 calls a graph, the median of 5 replays
    (16 calls in all, where cuda_ms makes 122). The plain versions are
    yardsticks that repeat a kernel's arithmetic in many launches, up to
    tens of ms a call at the long clip's shapes, and phase `kernels` times
    one at each of some 900 (kernel, shape, type) rows within the smoke's
    time limit."""
    return cuda_ms(fn, reps=5, per_graph=2)


def host_us(fn, calls: int = 1000) -> float:
    """Host µs per call of `fn`: the wall clock over `calls` back-to-back calls
    after a warm one, to the last call's end on the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_ms(fn, calls: int) -> dict:
    """Device time of one call of `fn` by kernel (function) name, in ms:
    the kernels' own time in a torch.profiler trace of `calls` calls, so the
    host's gaps between launches are left out. (A trace of one short call
    came back without its kernels, so several calls go into one trace.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)[<(]", e.key)
            out[name.group(1) if name else e.key] += e.device_time_total / 1e3 / calls
    return dict(out)


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3)


def attn_bound_ms(nbytes: float, flops: float, tag: str) -> tuple[float, str]:
    """bound_ms of an attention kernel's products: in bf16 at BF16_FLOPS, in
    f32 at F32_TC_FLOPS."""
    return bound_ms(nbytes, flops, BF16_FLOPS if tag == "bf16" else F32_TC_FLOPS)


def _larger(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(out, ref, atol, rtol, what) -> float:
    """Raise unless the kernel's output is finite and within tolerance of
    its plain version's; return the max abs error."""
    ok = ((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all().item()
    if not ok or not torch.isfinite(out.float()).all().item():
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(max abs err {max_err(out, ref):.3g})")
    return max_err(out, ref)


class KernelCase:
    """One kernel checked and timed at the shapes the census recorded."""

    def __init__(self, name):
        self.name = name
        self.err = {"f32": 0.0, "bf16": 0.0}
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms = None
        self.bound_share = {"bytes": 0.0, "operations": 0.0}
        self.detail = []
        # the backward kernels are also timed with f32 inputs, the trainer's type
        self.f32 = None
        # other numbers, summed over the shapes: bf16 F.linear (w8a8_matmul),
        # the kernel alone (winograd_conv3x3), launches that took the
        # tensor-core body in this phase's checks (both)
        self.notes = {}

    @property
    def bound_by(self):
        return max(self.bound_share, key=self.bound_share.get)

    def add_err(self, tag, err):
        self.err[tag] = max(self.err[tag], err)

    def add_time(self, ms, plain_ms, lib_ms, bound, by, shape, flops=None, **extra):
        """Times of one call at one shape; the case's totals are over its
        shapes. `extra` goes into the shape's --detail row only."""
        self.ms += ms
        self.plain_ms += plain_ms
        if lib_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + lib_ms
        self.bound += bound
        self.bound_share[by] += bound
        self.detail.append(dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bound, bound_by=by, **_rates(ms, bound, flops),
                                **extra))

    def add_time_f32(self, ms, plain_ms, lib_ms, bound, by, shape, flops=None, **extra):
        if self.f32 is None:
            self.f32 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0}
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            self.f32[key] += val
        if lib_ms is not None:
            self.f32["library_ms"] = (self.f32["library_ms"] or 0.0) + lib_ms
        self.detail.append(dict(shape=shape, dtype="f32", ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                                **_rates(ms, bound, flops), **extra))


def _rates(ms, bound, flops):
    """The --detail rates of one shape: the share of its bound that the
    kernel reached and, where the operations are given, TFLOP/s (TOP/s for
    the int8 GEMM)."""
    out = {"bound_share": bound / ms}
    if flops is not None:
        out["tflops"] = flops / ms / 1e9
    return out


def took(case, fn, rule, call, what, body="tc"):
    """Run `call` and raise unless it launched fn's tensor-core body (`body`
    "tc"), cluster body ("cluster") or flat body ("flat", gn_bwd_apply)
    exactly when `rule` says so (counted in case.notes["<body>_checked"]);
    returns the call's result."""
    counter = f"{body}_launches"
    before = getattr(fn, counter)
    out = call()
    if getattr(fn, counter) - before != int(rule):
        raise AssertionError(f"{what}: {'did not take' if rule else 'took'} the {body} body")
    case.notes[f"{body}_checked"] = case.notes.get(f"{body}_checked", 0) + int(rule)
    return out


def expect_misaligned_raises(fn, calls, what):
    """Each of `calls` passes fn a misaligned view where a tensor-core body
    runs: it must raise ValueError (the 16-byte check) before any launch."""
    launches = fn.launches
    for call in calls:
        try:
            call()
        except ValueError as e:
            if "16-byte" not in str(e):
                raise
        else:
            raise AssertionError(f"{what}: took a misaligned view onto the tensor-core body")
    if fn.launches != launches:
        raise AssertionError(f"{what}: a misaligned view launched the kernel")


def sdpa_backward(q, k, v, do, scale):
    """The backward half of scaled_dot_product_attention as one aten call on
    (BH, S, D) heads, its forward run here, outside the timed window:
    FlashAttention-2's backward for bf16, the memory-efficient kernel's for
    f32 (FlashAttention takes no f32); both are kernels sdpa's autograd runs."""
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    if q.dtype == torch.bfloat16:
        r = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False, False, scale=scale)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, False, r[6], r[7],
            scale=scale)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q4, k4, v4, do4))  # (B, S, H, D)
    r = aten._efficient_attention_forward(qt, kt, vt, None, None, None, None, None, 0.0, 0, True,
                                          scale=scale)
    return lambda: aten._efficient_attention_backward(
        dot, qt, kt, vt, None, r[0], None, None, r[4], r[5], r[1], 0.0, r[2], r[3], 0, False,
        scale=scale)


def attn_fwd_core(q, k, v, scale):
    """attn_fwd's static form on its CUDA-core body (tt_attn_fwd_core) at any
    head dim that body takes: at head dim 32 the body the tensor-core one
    replaced, timed beside it. On no path; no counter moves."""
    from tango_tpu_torch.ops import _build
    from tango_tpu_torch.ops.flash_attention import _DTYPES, _dims, _qscale

    o = torch.empty_like(q)
    lib = _build.load()
    code = lib.tt_attn_fwd_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                *_dims(q, k), _qscale(scale), _DTYPES[q.dtype],
                                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "tt_attn_fwd_core")
    return o


def gn_bwd_rows(half: str, x, g, mean, inv, gamma, beta, act, sums=None, count=None):
    """gn_bwd_stats ("stats") or gn_bwd_apply ("apply") on its streaming
    fallback, the body it replaced, at any shape and alignment (tt_gn_bwd_stats_rows
    / tt_gn_bwd_apply_rows), as its wrapper launched it then: stats with B*G
    group tickets zeroed for the call. A yardstick of the new bodies, on no
    path; no counter moves. Returns what the wrapper returns."""
    from tango_tpu_torch.ops import _build
    from tango_tpu_torch.ops.gn_silu import _DTYPES

    lib = _build.load()
    b, c, groups = x.shape[0], x.shape[1], mean.shape[1]
    hw = x.numel() // (b * c)
    ptrs = (x.data_ptr(), g.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
            beta.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if half == "stats":
        dparam = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
        out = torch.empty((b, groups, 2), device=x.device, dtype=torch.float32)
        done = torch.zeros(b * groups, device=x.device, dtype=torch.int32)
        code = lib.tt_gn_bwd_stats_rows(*ptrs, dparam.data_ptr(), out.data_ptr(), done.data_ptr(),
                                        b, c, hw, groups, int(act == "silu"), _DTYPES[x.dtype],
                                        stream)
        result = (out, dparam)
    else:
        result = torch.empty_like(x)
        code = lib.tt_gn_bwd_apply_rows(*ptrs, sums.data_ptr(), result.data_ptr(), b, c, hw,
                                        groups, float(count), int(act == "silu"),
                                        _DTYPES[x.dtype], stream)
    _build.check(lib, code, f"tt_gn_bwd_{half}_rows")
    return result


def check_kernels(ops, shapes: dict, train_shapes: dict, detail: bool):
    """Hold every kernel against its plain version at `shapes` (kernel name ->
    the argument shapes the serving and training paths launched it at) and
    time it there; `train_shapes` are the training path's alone."""
    from tango_tpu_torch.ops.flash_attention import (
        attn_bwd_dkv_plain,
        attn_bwd_dq_plain,
        attn_fwd_bias_plain,
        attn_fwd_plain,
        attn_fwd_v2_plain,
        tc_body,
    )
    from tango_tpu_torch.ops.gn_silu import (
        gn_apply_plain,
        gn_bwd_apply_flat_grid,
        gn_bwd_apply_plain,
        gn_bwd_cluster_size,
        gn_bwd_stats_cluster_size,
        gn_bwd_stats_plain,
        gn_fwd_cluster_size,
        gn_silu_bwd_plain,
        gn_silu_fwd_plain,
        gn_stats_plain,
    )

    K = ops.all_kernels()
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    dev = DEVICE

    def randn(*shape, dtype=torch.float32, scale=1.0, loc=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + loc).to(dtype)

    cases = {n: KernelCase(n) for n in K}
    tol = {"f32": (2e-5, 1e-4), "bf16": (2e-2, 2e-2)}
    # bf16 attention: outputs of unit-variance q, k, v are ~sqrt(e / Skv), at
    # most ~0.5, and the kernel and its plain version differ by one bf16 step
    # of the output (2e-3 measured, PERF.md); GroupNorm outputs reach ~5
    attn_tol = {"f32": (2e-5, 1e-4), "bf16": (4e-3, 1e-2)}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    fwd = K["gn_silu_fwd"]
    for shape, groups, act in sorted(shapes["gn_silu_fwd"], key=str):
        c, n = shape[1], math.prod(shape)
        g, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            r = gn_fwd_cluster_size(dt, shape[0], c, n // (shape[0] * c), groups)
            out = took(cases["gn_silu_fwd"], fwd, r > 0, lambda: fwd(x, g, b, groups, 1e-5, act),
                       f"gn_silu_fwd {shape} {tag}", body="cluster")
            ref = gn_silu_fwd_plain(x, g, b, groups, 1e-5, act)
            cases["gn_silu_fwd"].add_err(tag, assert_close(out, ref, *tol[tag],
                                                           f"gn_silu_fwd {shape} {tag}"))
            gl, bl = g.to(dt), b.to(dt)

            def lib():
                y = F.group_norm(x, groups, gl, bl, 1e-5)
                return F.silu(y) if act == "silu" else y

            add = cases["gn_silu_fwd"].add_time if tag == "bf16" else \
                cases["gn_silu_fwd"].add_time_f32
            add(cuda_ms(lambda: fwd(x, g, b, groups, 1e-5, act)),
                plain_cuda_ms(lambda: gn_silu_fwd_plain(x, g, b, groups, 1e-5, act)),
                cuda_ms(lib), *bound_ms(2 * x.element_size() * n + 8 * c, 8 * n, F32_FLOPS),
                [shape, groups, act], cluster_size=r, ctas=shape[0] * groups * r)
    x = randn(*HOST_US_SHAPE, dtype=torch.bfloat16)
    g, b = randn(HOST_US_SHAPE[1]), randn(HOST_US_SHAPE[1])
    cases["gn_silu_fwd"].notes["host_us_per_call"] = statistics.median(
        host_us(lambda: fwd(x, g, b, 32, 1e-5, "silu")) for _ in range(5))
    for shape, dt, offset in GN_FWD_STREAMING:
        c, n = shape[1], math.prod(shape)
        g, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        x = randn(n + offset, dtype=dt, scale=2.0, loc=0.5)[offset:].view(shape)
        tag = "f32" if dt == torch.float32 else "bf16"
        what = f"gn_silu_fwd {shape} {tag}, offset {offset}, streaming body"
        out = took(cases["gn_silu_fwd"], fwd, False, lambda: fwd(x, g, b, 32, 1e-5, "silu"),
                   what, body="cluster")
        cases["gn_silu_fwd"].add_err(tag, assert_close(
            out, gn_silu_fwd_plain(x, g, b, 32, 1e-5, "silu"), *tol[tag], what))
        del x, out

    for shape, groups, chunks in sorted(shapes["gn_stats"], key=str):
        n = math.prod(shape)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            out = K["gn_stats"](x, groups, chunks)
            ref = gn_stats_plain(x, groups, chunks)
            # partial sums of up to ~10^5 terms: relative tolerance only
            cases["gn_stats"].add_err(tag, assert_close(out, ref, 0.0, 1e-4,
                                                        f"gn_stats {shape} {tag}"))
            add = cases["gn_stats"].add_time if tag == "bf16" else cases["gn_stats"].add_time_f32
            add(cuda_ms(lambda: K["gn_stats"](x, groups, chunks)),
                plain_cuda_ms(lambda: gn_stats_plain(x, groups, chunks)), None,
                *bound_ms(x.element_size() * n + 8 * shape[0] * groups * chunks, 3 * n,
                          F32_FLOPS), [shape, groups, chunks])

    for shape, act in sorted(shapes["gn_apply"], key=str):
        bsz, c = shape[0], shape[1]
        a, bb = randn(bsz, c, scale=0.3, loc=1.0), randn(bsz, c, scale=0.1)
        n = math.prod(shape)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0)
            out = K["gn_apply"](x, a, bb, act)
            ref = gn_apply_plain(x, a, bb, act)
            cases["gn_apply"].add_err(tag, assert_close(out, ref, *tol[tag],
                                                        f"gn_apply {shape} {tag}"))
            add = cases["gn_apply"].add_time if tag == "bf16" else cases["gn_apply"].add_time_f32
            add(cuda_ms(lambda: K["gn_apply"](x, a, bb, act)),
                plain_cuda_ms(lambda: gn_apply_plain(x, a, bb, act)), None,
                *bound_ms(2 * x.element_size() * n + 16 * bsz * c, 6 * n, F32_FLOPS),
                [shape, act])

    def attention_fwd(name, plain):
        """attn_fwd or attn_fwd_v2 at every launched shape, in f32 and bf16,
        each checked, held to the body `tc_body` names for its form (every
        call at head dim 64, and attn_fwd's at 32, on a tensor-core body,
        3xTF32 in f32) and timed; attn_fwd at head dim 32 also beside its
        CUDA-core body (`d32` note); at TC_SHAPES, checked only, in each type
        that has a tensor-core body."""
        fn = K[name]
        for qshape, kshape in sorted(shapes[name], key=str):
            bh, sq, d = qshape
            skv = kshape[1]
            scale = d**-0.5
            flops = 4 * bh * sq * skv * d  # S = Q K^T, then P V
            for tag, dt in dtypes.items():
                q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
                what = f"{name} {qshape} {tag}"
                out = took(cases[name], fn, tc_body(dt, d, fn.form), lambda: fn(q, k, v, scale),
                           what)
                cases[name].add_err(tag, assert_close(out, plain(q, k, v, scale), *attn_tol[tag],
                                                      what))
                q4, k4, v4 = (t.reshape(1, bh, -1, d) for t in (q, k, v))
                add = cases[name].add_time if tag == "bf16" else cases[name].add_time_f32
                times = (cuda_ms(lambda: fn(q, k, v, scale)),
                         plain_cuda_ms(lambda: plain(q, k, v, scale)),
                         cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                        scale=scale)))
                bound = attn_bound_ms(q.element_size() * (2 * bh * sq * d + 2 * bh * skv * d),
                                      flops, tag)
                add(*times, *bound, [qshape, kshape], flops=flops)
                if d == 32 and name == "attn_fwd":
                    # AudioLDM's head dim: the tensor-core body's own totals,
                    # beside the CUDA-core body it replaced at the same
                    # shapes (checked too) and the exp2 floor (a logit each)
                    assert_close(attn_fwd_core(q, k, v, scale), plain(q, k, v, scale),
                                 *attn_tol[tag], f"{what}, CUDA-core body")
                    row = cases[name].notes.setdefault("d32", {}).setdefault(
                        tag, {"shapes": 0, "ms": 0.0, "core_ms": 0.0, "plain_ms": 0.0,
                              "library_ms": 0.0, "bound_ms": 0.0, "exp2_floor_ms": 0.0})
                    row["shapes"] += 1
                    core_ms = cuda_ms(lambda: attn_fwd_core(q, k, v, scale))
                    floor_ms = 1e3 * bh * sq * skv / EX2_PER_S
                    for key, val in zip(("ms", "plain_ms", "library_ms", "bound_ms", "core_ms",
                                         "exp2_floor_ms"), (*times, bound[0], core_ms, floor_ms)):
                        row[key] += val
        for qshape, kshape in TC_SHAPES[name]:
            scale = qshape[2] ** -0.5
            for tag, dt in dtypes.items():
                if not tc_body(dt, qshape[2], fn.form):
                    continue
                q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
                what = f"{name} {qshape} x {kshape[1]} keys {tag}"
                out = took(cases[name], fn, True, lambda: fn(q, k, v, scale), what)
                cases[name].add_err(tag, assert_close(out, plain(q, k, v, scale), *attn_tol[tag],
                                                      what))

    attention_fwd("attn_fwd", attn_fwd_plain)
    # the training shapes (head dim 64) and AudioLDM's (head dim 32)
    fwd_amplitude_checks(K, cases, "attn_fwd", sorted(train_shapes["attn_fwd"], key=str)
                         + sorted((s for s in shapes["attn_fwd"] if s[0][2] == 32), key=str))

    # the extreme-logit window and the underflow row (tests/test_flash_attention.py)
    for tag, dt in dtypes.items():
        for sign, ck0, want_zero in ((1.0, 220.0, False), (-1.0, 220.0, False),
                                     (-1.0, 480.0, True)):
            u = randn(64)
            u = u / u.norm()
            cq = 2.0 + 0.2 * torch.rand(128, 1, generator=gen, device=dev)
            ck = ck0 + 8.0 * torch.rand(256, 1, generator=gen, device=dev)
            q = (cq * u + 0.01 * randn(128, 64))[None].to(dt)
            k = (sign * ck * u + 0.01 * randn(256, 64))[None].to(dt)
            v = randn(1, 256, 64, dtype=dt)
            out = K["attn_fwd"](q, k, v, 0.125)
            ref = attn_fwd_plain(q, k, v, 0.125)
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"attn_fwd extreme logits {sign} {ck0} {tag}: not finite")
            if want_zero:
                if out.abs().max().item() != 0.0:
                    raise AssertionError(f"attn_fwd underflow {tag}: rows are not zero")
            else:
                atol, rtol = (5e-5, 1e-3) if tag == "f32" else attn_tol[tag]
                cases["attn_fwd"].add_err(tag, assert_close(
                    out, ref, atol, rtol, f"attn_fwd extreme logits {sign} {tag}"))

    # ---- the long-clip and long-prompt forward kernels
    attention_fwd("attn_fwd_v2", attn_fwd_v2_plain)
    fwd_amplitude_checks(K, cases, "attn_fwd_v2", sorted(shapes["attn_fwd_v2"], key=str))
    fwd_amplitude_checks(K, cases, "attn_fwd_bias", sorted(shapes["attn_fwd_bias"], key=str))

    def bias_case(qshape, kshape, bshape, dt):
        """q, k, v of the shapes, and the padding bias (B, 1 | Sq, Skv) of a
        short prompt in a longer context (the first few keys open, a
        different number in each batch row), with unit noise where each
        query has its own row."""
        bias = padding_bias(bshape, 4)
        if bshape[1] > 1:
            bias += randn(*bshape)
        return [randn(*s, dtype=dt) for s in (qshape, kshape, kshape)] + [bias]

    fn = K["attn_fwd_bias"]
    for qshape, kshape, bshape in sorted(shapes["attn_fwd_bias"], key=str) + BIAS_TC_SHAPES:
        bh, sq, d = qshape
        skv = kshape[1]
        nb, rows = bshape[0], bshape[1]
        heads = bh // nb
        scale = d**-0.5
        timed = (qshape, kshape, bshape) in shapes["attn_fwd_bias"]
        for tag, dt in dtypes.items():
            q, k, v, bias = bias_case(qshape, kshape, bshape, dt)
            what = f"attn_fwd_bias {qshape} {kshape} {bshape} {tag}"
            out = took(cases["attn_fwd_bias"], fn, tc_body(dt, d, "bias"),
                       lambda: fn(q, k, v, bias, heads, scale), what)
            cases["attn_fwd_bias"].add_err(tag, assert_close(
                out, attn_fwd_bias_plain(q, k, v, bias, heads, scale), *attn_tol[tag], what))
            if not timed:
                continue
            # both types timed (f32 on the 3xTF32 body, in the `f32` field)
            q4, k4, v4 = (t.reshape(nb, heads, -1, d) for t in (q, k, v))
            mask4 = bias[:, None].to(q.dtype)  # sdpa takes a float mask of q's type
            add = cases["attn_fwd_bias"].add_time if tag == "bf16" else \
                cases["attn_fwd_bias"].add_time_f32
            add(cuda_ms(lambda: fn(q, k, v, bias, heads, scale)),
                plain_cuda_ms(lambda: attn_fwd_bias_plain(q, k, v, bias, heads, scale)),
                cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4,
                                                               scale=scale)),
                *attn_bound_ms(q.element_size() * (2 * bh * sq * d + 2 * bh * skv * d)
                               + 4 * nb * rows * skv, 4 * bh * sq * skv * d, tag),
                [qshape, kshape, bshape], flops=4 * bh * sq * skv * d)

    # misaligned views where a tensor-core forward body runs: must raise
    good16, bias1 = randn(2, 128, 64, dtype=torch.bfloat16), torch.zeros(1, 1, 128, device=dev)
    bad16 = torch.zeros(good16.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(2, 128, 64)
    bad_bias = torch.zeros(129, device=dev)[1:].view(1, 1, 128)
    expect_misaligned_raises(fn, (lambda: fn(bad16, good16, good16, bias1, 2, 0.125),
                                  lambda: fn(good16, good16, good16, bad_bias, 2, 0.125)),
                             "attn_fwd_bias bf16")
    good32 = randn(2, 128, 64)
    bad32 = torch.zeros(good32.numel() + 1, device=dev)[1:].view(2, 128, 64)
    for name in ("attn_fwd", "attn_fwd_v2"):
        expect_misaligned_raises(K[name], (lambda: K[name](good32, bad32, good32, 0.125),),
                                 f"{name} f32")
    expect_misaligned_raises(fn, (lambda: fn(good32, bad32, good32, bias1, 2, 0.125),
                                  lambda: fn(good32, good32, good32, bad_bias, 2, 0.125)),
                             "attn_fwd_bias f32")

    # JAX's extreme-logit case for v2 (row maxes near natural +100, past the
    # static-shift window): the kernel stays exact; and a batch row whose keys
    # are all masked for the bias kernel: finite. The plain version's base-2
    # logits sit near -14427, where an f32 keeps 2^-10 of absolute precision,
    # so its p carries up to ~7e-4 of relative rounding (the f32 kernel takes
    # the row's largest bias off first): atol 1e-3 on that row (the other row
    # at the usual limits).
    for tag, dt in dtypes.items():
        u = randn(64)
        u = u / u.norm()
        cq = 2.0 + 0.2 * torch.rand(128, 1, generator=gen, device=dev)
        ck = 380.0 + 8.0 * torch.rand(256, 1, generator=gen, device=dev)
        q = (cq * u + 0.01 * randn(128, 64))[None].to(dt)
        k = (ck * u + 0.01 * randn(256, 64))[None].to(dt)
        v = randn(1, 256, 64, dtype=dt)
        out = took(cases["attn_fwd_v2"], K["attn_fwd_v2"], tc_body(dt, 64, "online"),
                   lambda: K["attn_fwd_v2"](q, k, v, 0.125), f"attn_fwd_v2 extreme logits {tag}")
        ref = attn_fwd_v2_plain(q, k, v, 0.125)
        atol, rtol = (5e-5, 1e-3) if tag == "f32" else attn_tol[tag]
        cases["attn_fwd_v2"].add_err(tag, assert_close(out, ref, atol, rtol,
                                                       f"attn_fwd_v2 extreme logits {tag}"))
        q, k, v = (randn(8, 256, 64, dtype=dt) for _ in range(3))
        bias = torch.zeros(2, 1, 256, device=dev)
        bias[0, :, 5:] = -10000.0
        bias[1] = -10000.0
        out = took(cases["attn_fwd_bias"], fn, tc_body(dt, 64, "bias"),
                   lambda: fn(q, k, v, bias, 4, 0.125), f"attn_fwd_bias masked rows {tag}")
        ref = attn_fwd_bias_plain(q, k, v, bias, 4, 0.125)
        cases["attn_fwd_bias"].add_err(tag, assert_close(
            out[:4], ref[:4], *attn_tol[tag], f"attn_fwd_bias masked row {tag}"))
        cases["attn_fwd_bias"].notes[f"all_masked_row_err_{tag}"] = assert_close(
            out[4:], ref[4:], 1e-3 if tag == "f32" else attn_tol[tag][0],
            0.0 if tag == "f32" else attn_tol[tag][1], f"attn_fwd_bias all-masked row {tag}")

    # ---- the backward kernels, at the shapes of the training path
    # f32 at the JAX backward tests' limits (tests/test_flash_attention.py:156,
    # tests/test_gn_pallas.py:90); bf16 from the readings in PERF.md: one bf16
    # step of outputs below ~1.2 (attention, 2.0e-3 measured) and below ~4
    # (GroupNorm dx, 7.8e-3 measured). lse and delta are f32 in both types.
    attn_bwd_tol = {"f32": (1e-4, 1e-3), "bf16": (4e-3, 1e-2)}
    gn_bwd_tol = {"f32": (2e-4, 1e-3), "bf16": (2e-2, 2e-2)}
    stat_tol = (1e-4, 1e-3)
    for qshape, kshape in sorted(shapes["attn_bwd_dq"] | shapes["attn_bwd_dkv"], key=str):
        bh, sq, d = qshape
        skv = kshape[1]
        scale = d**-0.5
        for tag, dt in dtypes.items():
            q, k, v = (randn(*s, dtype=dt) for s in (qshape, kshape, kshape))
            do = randn(*qshape, dtype=dt)
            lse, delta = check_bwd(K, cases, q, k, v, do, scale, attn_bwd_tol[tag], stat_tol,
                                   f"{qshape} {kshape} {tag}")

            lib = cuda_ms(sdpa_backward(q, k, v, do, scale))
            isz = q.element_size()
            qkvo = bh * (2 * sq + 2 * skv) * d * isz  # q, k, v, do read
            stats = 2 * 4 * bh * sq                     # lse, delta
            product = 2 * bh * sq * skv * d
            # (name, kernel, plain version, bytes moved, products): dq S, dP
            # and dQ; dkv S^T, dP^T, dV and dK
            timing = [
                ("attn_bwd_dq", lambda: K["attn_bwd_dq"](q, k, v, do, scale),
                 lambda: attn_bwd_dq_plain(q, k, v, do, scale),
                 qkvo + bh * sq * d * isz + stats, 3),
                ("attn_bwd_dkv", lambda: K["attn_bwd_dkv"](q, k, v, do, lse, delta, scale),
                 lambda: attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale),
                 qkvo + stats + 2 * bh * skv * d * isz, 4),
            ]
            for name, kern, plain, nbytes, products in timing:
                add = cases[name].add_time if tag == "bf16" else cases[name].add_time_f32
                add(cuda_ms(kern), plain_cuda_ms(plain), lib,
                    *attn_bound_ms(nbytes, products * product, tag), [qshape, kshape],
                    flops=products * product)
    bwd_tc_checks(K, cases, shapes, randn, attn_bwd_tol, stat_tol)

    bwd = K["gn_silu_bwd"]
    for shape, groups, act in sorted(shapes["gn_silu_bwd"], key=str):
        c = shape[1]
        w, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        n = math.prod(shape)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            g = randn(*shape, dtype=dt)
            r = gn_bwd_cluster_size(dt, shape[0], c, n // (shape[0] * c), groups)
            out = took(cases["gn_silu_bwd"], bwd, r > 0,
                       lambda: bwd(x, g, w, b, groups, 1e-5, act),
                       f"gn_silu_bwd {shape} {tag}", body="cluster")
            ref = gn_silu_bwd_plain(x, g, w, b, groups, 1e-5, act)
            cases["gn_silu_bwd"].add_err(tag, max(
                assert_close(o, r, *gn_bwd_tol[tag], f"gn_silu_bwd {part} {shape} {tag}")
                for o, r, part in zip(out, ref, ("dx", "dgamma", "dbeta"))))

            # aten's GroupNorm backward (after silu's) from the forward's statistics
            wl, bl = w.to(dt), b.to(dt)
            hw = n // (shape[0] * c)
            y, mean, rstd = torch.ops.aten.native_group_norm(x, wl, bl, shape[0], c, hw, groups,
                                                             1e-5)

            def lib():
                gy = torch.ops.aten.silu_backward(g, y) if act == "silu" else g
                return torch.ops.aten.native_group_norm_backward(
                    gy, x, mean, rstd, wl, shape[0], c, hw, groups, [True, True, True])

            add = cases["gn_silu_bwd"].add_time if tag == "bf16" else \
                cases["gn_silu_bwd"].add_time_f32
            add(cuda_ms(lambda: bwd(x, g, w, b, groups, 1e-5, act)),
                plain_cuda_ms(lambda: gn_silu_bwd_plain(x, g, w, b, groups, 1e-5, act)),
                cuda_ms(lib), *bound_ms(3 * n * x.element_size(), 24 * n, F32_FLOPS),
                [shape, groups, act], cluster_size=r, ctas=shape[0] * groups * r)

    # the GroupNorm backward split at its group sums (sequence parallelism)
    # at the slabs' shapes, each half against its plain version (gn_bwd_apply
    # on the plain sums), each call held to its new body, timed in both
    # types beside the streaming fallbacks (the bodies they replaced) in the same
    # call; the yardstick is aten's GroupNorm backward of the same slab, one
    # call for all of dx, dgamma and dbeta of a group the slab holds whole
    # (the pair's work, less the all-reduce between them)
    split = {n: K[n] for n in ("gn_bwd_stats", "gn_bwd_apply")}
    for shape, groups, act in sorted(shapes["gn_bwd_stats"] | shapes["gn_bwd_apply"], key=str):
        bsz, c, n = shape[0], shape[1], math.prod(shape)
        hw = n // (bsz * c)
        count = 2 * n // (bsz * groups)  # the group over SP = 2's two slabs
        w, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        for tag, dt in dtypes.items():
            x = randn(*shape, dtype=dt, scale=2.0, loc=0.5)
            g = randn(*shape, dtype=dt)
            xf = x.float().reshape(bsz, groups, -1)
            mean = xf.mean(-1).contiguous()
            inv = torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5).contiguous()
            stats = (x, g, mean, inv, w, b, act)
            what = f"{shape} {act} {tag}"
            r = gn_bwd_stats_cluster_size(dt, bsz, c, hw, groups)
            sums, dparam = took(cases["gn_bwd_stats"], split["gn_bwd_stats"], r > 0,
                                lambda: split["gn_bwd_stats"](*stats), f"gn_bwd_stats {what}",
                                body="cluster")
            rsums, rdparam = gn_bwd_stats_plain(*stats)
            rdx = gn_bwd_apply_plain(*stats, rsums, count)
            cases["gn_bwd_stats"].add_err(tag, max(
                assert_close(sums, rsums, *gn_bwd_tol[tag], f"gn_bwd_stats sums {what}"),
                assert_close(dparam, rdparam, *gn_bwd_tol[tag], f"gn_bwd_stats dparam {what}")))
            cases["gn_bwd_apply"].add_err(tag, assert_close(
                took(cases["gn_bwd_apply"], split["gn_bwd_apply"], True,
                     lambda: split["gn_bwd_apply"](*stats, rsums, count), f"gn_bwd_apply {what}",
                     body="flat"),
                rdx, *gn_bwd_tol[tag], f"gn_bwd_apply {what}"))
            # the streaming fallbacks at the same inputs: checked, timed
            parent = {"gn_bwd_stats": lambda: gn_bwd_rows("stats", *stats),
                      "gn_bwd_apply": lambda: gn_bwd_rows("apply", *stats, rsums, count)}
            psums, pdparam = parent["gn_bwd_stats"]()
            cases["gn_bwd_stats"].add_err(tag, max(
                assert_close(psums, rsums, *gn_bwd_tol[tag], f"gn_bwd_stats fallback {what}"),
                assert_close(pdparam, rdparam, *gn_bwd_tol[tag], f"gn_bwd_stats fallback {what}")))
            cases["gn_bwd_apply"].add_err(tag, assert_close(
                parent["gn_bwd_apply"](), rdx, *gn_bwd_tol[tag], f"gn_bwd_apply fallback {what}"))
            k, ctas = gn_bwd_apply_flat_grid(dt, n)
            extra = {"gn_bwd_stats": {"cluster_size": r, "ctas": bsz * groups * r},
                     "gn_bwd_apply": {"packets_per_thread": k, "ctas": ctas}}
            wl, bl = w.to(dt), b.to(dt)
            y, mu, rstd = torch.ops.aten.native_group_norm(x, wl, bl, bsz, c, hw, groups, 1e-5)

            def lib():
                gy = torch.ops.aten.silu_backward(g, y) if act == "silu" else g
                return torch.ops.aten.native_group_norm_backward(
                    gy, x, mu, rstd, wl, bsz, c, hw, groups, [True, True, True])

            lib_ms = cuda_ms(lib)
            esize = x.element_size()
            for name, kern, plain, nbytes, flops in (
                    ("gn_bwd_stats", lambda: split["gn_bwd_stats"](*stats),
                     lambda: gn_bwd_stats_plain(*stats), 2 * n * esize + 8 * bsz * (c + groups),
                     16 * n),
                    ("gn_bwd_apply", lambda: split["gn_bwd_apply"](*stats, rsums, count),
                     lambda: gn_bwd_apply_plain(*stats, rsums, count), 3 * n * esize, 20 * n)):
                add = cases[name].add_time if tag == "bf16" else cases[name].add_time_f32
                parent_ms = cuda_ms(parent[name])
                notes = cases[name].notes.setdefault("parent_ms", {"bf16": 0.0, "f32": 0.0})
                notes[tag] += parent_ms
                add(cuda_ms(kern), plain_cuda_ms(plain), lib_ms,
                    *bound_ms(nbytes, flops, F32_FLOPS), [shape, groups, act],
                    parent_ms=parent_ms, **extra[name])

    for shape, groups, dt, offset in GN_SPLIT_STREAMING:
        c, n = shape[1], math.prod(shape)
        w, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        x = randn(n + offset, dtype=dt, scale=2.0, loc=0.5)[offset:].view(shape)
        g = randn(n + offset, dtype=dt)[offset:].view(shape)
        xf = x.float().reshape(shape[0], groups, -1)
        stats = (x, g, xf.mean(-1).contiguous(),
                 torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5).contiguous(), w, b, "silu")
        tag = "f32" if dt == torch.float32 else "bf16"
        what = f"{shape} {tag}, offset {offset}, streaming fallback"
        sums, dparam = took(cases["gn_bwd_stats"], split["gn_bwd_stats"], False,
                            lambda: split["gn_bwd_stats"](*stats), f"gn_bwd_stats {what}",
                            body="cluster")
        rsums, rdparam = gn_bwd_stats_plain(*stats)
        dx = took(cases["gn_bwd_apply"], split["gn_bwd_apply"], False,
                  lambda: split["gn_bwd_apply"](*stats, rsums, n // groups),
                  f"gn_bwd_apply {what}", body="flat")
        cases["gn_bwd_stats"].add_err(tag, max(
            assert_close(sums, rsums, *gn_bwd_tol[tag], f"gn_bwd_stats sums {what}"),
            assert_close(dparam, rdparam, *gn_bwd_tol[tag], f"gn_bwd_stats dparam {what}")))
        cases["gn_bwd_apply"].add_err(tag, assert_close(
            dx, gn_bwd_apply_plain(*stats, rsums, n // groups), *gn_bwd_tol[tag],
            f"gn_bwd_apply {what}"))

    for shape, dt, offset in GN_BWD_STREAMING:
        c, n = shape[1], math.prod(shape)
        w, b = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
        x = randn(n + offset, dtype=dt, scale=2.0, loc=0.5)[offset:].view(shape)
        g = randn(n + offset, dtype=dt)[offset:].view(shape)
        tag = "f32" if dt == torch.float32 else "bf16"
        what = f"gn_silu_bwd {shape} {tag}, offset {offset}, streaming body"
        out = took(cases["gn_silu_bwd"], bwd, False, lambda: bwd(x, g, w, b, 32, 1e-5, "silu"),
                   what, body="cluster")
        ref = gn_silu_bwd_plain(x, g, w, b, 32, 1e-5, "silu")
        cases["gn_silu_bwd"].add_err(tag, max(
            assert_close(o, r, *gn_bwd_tol[tag], f"{what} {part}")
            for o, r, part in zip(out, ref, ("dx", "dgamma", "dbeta"))))
        del x, g, out, ref

    int8_and_winograd(K, cases, shapes, randn, detail)
    limit_checks(K, cases, randn, tol, attn_tol, gn_bwd_tol, attn_bwd_tol)
    if detail:
        for case in cases.values():
            for row in case.detail:
                log("kernel_shape", name=case.name, **row)
    return cases


def path_shape_times(cases: dict, path_shapes: dict) -> dict:
    """A path's own shapes in the kernels phase: by kernel and dtype, the
    shapes, and the sums of their rows' ms, plain_ms, library_ms and
    bound_ms (the rows `check_kernels` timed at those shapes)."""
    norm = lambda x: json.dumps(x, default=list)  # noqa: E731  tuples and lists alike
    out = {}
    for name, shapes in path_shapes.items():
        want = {norm(s) for s in shapes}
        for row in cases[name].detail if name in cases else ():
            if norm(row["shape"]) not in want:
                continue
            rec = out.setdefault(name, {}).setdefault(row.get("dtype", "bf16"), {
                "shapes": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0})
            rec["shapes"] += 1
            for key in ("ms", "plain_ms", "bound_ms", "parent_ms"):
                if key in row:
                    rec[key] = rec.get(key, 0.0) + row[key]
            if row["library_ms"] is not None:
                rec["library_ms"] = (rec["library_ms"] or 0.0) + row["library_ms"]
    return out


def check_bwd(K, cases, q, k, v, do, scale, tol, stat_tol, what):
    """attn_bwd_dq, then attn_bwd_dkv on its lse and delta, against their
    plain versions; returns the kernel's lse and delta."""
    from tango_tpu_torch.ops.flash_attention import attn_bwd_dkv_plain, attn_bwd_dq_plain

    tag = "f32" if q.dtype == torch.float32 else "bf16"
    dq, lse, delta = K["attn_bwd_dq"](q, k, v, do, scale)
    rq, rl, rd = attn_bwd_dq_plain(q, k, v, do, scale)
    cases["attn_bwd_dq"].add_err(tag, max(
        assert_close(dq, rq, *tol, f"attn_bwd_dq dq {what}"),
        assert_close(lse, rl, *stat_tol, f"attn_bwd_dq lse {what}"),
        assert_close(delta, rd, *stat_tol, f"attn_bwd_dq delta {what}")))
    dk, dv = K["attn_bwd_dkv"](q, k, v, do, lse, delta, scale)
    rk, rv = attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    cases["attn_bwd_dkv"].add_err(tag, max(
        assert_close(dk, rk, *tol, f"attn_bwd_dkv dk {what}"),
        assert_close(dv, rv, *tol, f"attn_bwd_dkv dv {what}")))
    return lse, delta


def attn_bwd_float64(q, k, v, do, scale):
    """(dq, dk, dv, lse, delta) of softmax(q k^T * scale) v in float64: the
    plain versions' formula, exact to f32's eye."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.transpose(-1, -2), do), lse[..., 0], delta[..., 0])


def bound_ratio(out, ref, atol, rtol) -> float:
    """The largest |out - ref| / (atol + rtol |ref|): at most 1 meets the
    limits."""
    return ((out.double() - ref.double()).abs() / (atol + rtol * ref.double().abs())).max().item()


def max_abs_rel(out, ref, floor) -> dict:
    """max |out - ref| and max |out - ref| / |ref| over the elements with
    |ref| >= floor (below it the limits' absolute term decides)."""
    d = (out.double() - ref.double()).abs()
    big = ref.double().abs() >= floor
    rel = (d[big] / ref.double().abs()[big]).max().item() if big.any() else 0.0
    return {"max_abs": d.max().item(), "max_rel": rel}


def padding_bias(bshape, first):
    """The padding bias (B, rows, Skv) f32 of a short prompt in a longer
    context: 0 on the first `first` + 3i keys of batch row i, -10000 on the
    others, the same for every row."""
    nb, rows, skv = bshape
    keep = torch.arange(nb, device=DEVICE)[:, None, None] * 3 + first
    bias = torch.where(torch.arange(skv, device=DEVICE)[None, None, :] < keep, 0.0, -10000.0)
    return bias.expand(nb, rows, skv).contiguous()


def fwd_amplitude_checks(K, cases, name, launched):
    """The f32 forward's tensor-core body (3xTF32) of attn_fwd, attn_fwd_v2
    or attn_fwd_bias (`name`) with q and k at amplitude BWD_TC_AMPLITUDE at
    the shapes `launched`, drawn from each of FWD_TC_AMPLITUDE_SEEDS (the
    biased form with a padding bias that leaves a quarter of the keys and a
    few more open): held to JAX's f32 forward limits (2e-5 / 1e-4) against
    the same softmax in float64, raising on a miss; the float64 reference is
    taken a few heads at a time (at most 2^28 logits, 2 GB). Phase
    `fwd_amplitude` logs the kernel's and the plain version's share of those
    limits and their max-abs and max-rel differences."""
    from tango_tpu_torch.ops import flash_attention as fa

    plain = getattr(fa, f"{name}_plain")
    tol = (2e-5, 1e-4)
    for seed in FWD_TC_AMPLITUDE_SEEDS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        for qshape, kshape, *bshape in launched:
            q, k = (torch.randn(s, generator=gen, device=DEVICE) * BWD_TC_AMPLITUDE
                    for s in (qshape, kshape))
            v = torch.randn(kshape, generator=gen, device=DEVICE)
            scale = qshape[2] ** -0.5
            args, bias = (q, k, v), None
            if bshape:  # attn_fwd_bias: the heads of a batch row share its bias row
                bias = padding_bias(bshape[0], kshape[1] // 4)
                heads = qshape[0] // bshape[0][0]
                args = (q, k, v, bias, heads)
            what = f"{name} {qshape} q, k at amplitude {BWD_TC_AMPLITUDE} f32, seed {seed}"
            kern = took(cases[name], K[name], True, lambda: K[name](*args, scale), what)
            ref = plain(*args, scale)
            share = {"kernel": 0.0, "plain": 0.0}
            diff = {w: {"max_abs": 0.0, "max_rel": 0.0} for w in share}
            step = max(1, 2**28 // (qshape[1] * kshape[1]))
            for h in range(0, qshape[0], step):
                qd, kd, vd = (t[h:h + step].double() for t in (q, k, v))
                logits = qd @ kd.transpose(-1, -2) * scale
                if bias is not None:
                    logits += bias.double().repeat_interleave(heads, 0)[h:h + step]
                exact = torch.softmax(logits, -1) @ vd
                assert_close(kern[h:h + step], exact, *tol, f"{what}, against float64")
                for who, out in (("kernel", kern), ("plain", ref)):
                    share[who] = max(share[who], bound_ratio(out[h:h + step], exact, *tol))
                    d = max_abs_rel(out[h:h + step], exact, tol[0])
                    diff[who] = {f: max(diff[who][f], d[f]) for f in d}
                del qd, kd, vd, logits, exact
            log("fwd_amplitude", name=name, shape=[qshape, kshape, *bshape],
                amplitude=BWD_TC_AMPLITUDE,
                seed=seed, **{f"{who}_vs_float64": {"share_of_limit": round(share[who], 4),
                                                    **diff[who]} for who in share})
            del kern, ref
            torch.cuda.empty_cache()


def bwd_tc_checks(K, cases, shapes, randn, attn_bwd_tol, stat_tol):
    """The backward's tensor-core body (f32 and bf16 at head dim 64) beyond
    the launched shapes, checked only: a ragged shape in both types; q and k
    at amplitude BWD_TC_AMPLITUDE in f32 at the training shapes, drawn from
    each of BWD_TC_AMPLITUDE_SEEDS (logits three times as large); and a
    misaligned view, which must raise before any launch.

    In the amplitude case dq, dk and dv are held to JAX's limits both
    against their plain versions and against the same formula in float64;
    lse and delta against float64 only: at amplitude 3 the f32 logits of the
    plain versions carry ~5e-5 of rounding, which exp turns into a relative
    error of p, so the plain lse and delta sit up to ~0.65 of JAX's limits
    from the exact values, and a comparison with them adds two errors of
    that size. Phase `bwd_amplitude` logs each distance's share of the
    limits and the max-abs and max-rel differences of dq, dk and dv."""
    from tango_tpu_torch.ops.flash_attention import (
        attn_bwd_dkv_plain,
        attn_bwd_dq_plain,
        bwd_tc_body,
    )

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    qshape, kshape = BWD_TC_RAGGED
    for tag, dt in dtypes.items():
        q, do = (randn(*qshape, dtype=dt) for _ in range(2))
        k, v = (randn(*kshape, dtype=dt) for _ in range(2))
        check_bwd(K, cases, q, k, v, do, 0.125, attn_bwd_tol[tag], stat_tol,
                  f"{qshape} x {kshape[1]} keys {tag}")
    names = ("dq", "dk", "dv", "lse", "delta")
    launched = [s for s in sorted(shapes["attn_bwd_dq"], key=str)
                if bwd_tc_body(torch.float32, s[0][2])]
    for seed in BWD_TC_AMPLITUDE_SEEDS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        for qshape, kshape in launched:
            q, k = (torch.randn(s, generator=gen, device=DEVICE) * BWD_TC_AMPLITUDE
                    for s in (qshape, kshape))
            v = torch.randn(kshape, generator=gen, device=DEVICE)
            do = torch.randn(qshape, generator=gen, device=DEVICE)
            scale = qshape[2] ** -0.5
            dq, lse, delta = K["attn_bwd_dq"](q, k, v, do, scale)
            kern = (dq, *K["attn_bwd_dkv"](q, k, v, do, lse, delta, scale), lse, delta)
            rq, rl, rd = attn_bwd_dq_plain(q, k, v, do, scale)
            plain = (rq, *attn_bwd_dkv_plain(q, k, v, do, rl, rd, scale), rl, rd)
            exact = attn_bwd_float64(q, k, v, do, scale)
            what = f"{qshape} q, k at amplitude {BWD_TC_AMPLITUDE} f32, seed {seed}"
            # raises on a miss; not added to the kernels line's errors, which
            # are against the plain versions at the path's inputs
            for i, name in enumerate(names):
                tol = attn_bwd_tol["f32"] if i < 3 else stat_tol
                kernel = "attn_bwd_dq" if name in ("dq", "lse", "delta") else "attn_bwd_dkv"
                assert_close(kern[i], exact[i], *tol, f"{kernel} {name} {what}, against float64")
                if i < 3:
                    assert_close(kern[i], plain[i], *tol, f"{kernel} {name} {what}")
            log("bwd_amplitude", shape=[qshape, kshape], amplitude=BWD_TC_AMPLITUDE, seed=seed,
                **{f"{who}_share_of_limit": {
                    n: round(bound_ratio(a, b, *(attn_bwd_tol["f32"] if i < 3 else stat_tol)), 4)
                    for i, (n, a, b) in enumerate(zip(names, x, y))}
                   for who, x, y in (("kernel_vs_float64", kern, exact),
                                     ("plain_vs_float64", plain, exact),
                                     ("kernel_vs_plain", kern, plain))},
                **{f"{who}_differences": {
                    n: max_abs_rel(a, b, attn_bwd_tol["f32"][0])
                    for n, a, b in zip(names[:3], x, y)}
                   for who, x, y in (("kernel_vs_float64", kern, exact),
                                     ("kernel_vs_plain", kern, plain))})
            del kern, plain, exact
            torch.cuda.empty_cache()
    good = randn(1, 128, 64)
    bad = torch.zeros(good.numel() + 1, device=good.device)[1:].view(1, 128, 64)
    lse = torch.zeros(1, 128, device=good.device)
    expect_misaligned_raises(K["attn_bwd_dq"], (lambda: K["attn_bwd_dq"](good, good, bad, good,
                                                                          0.125),), "attn_bwd_dq")
    expect_misaligned_raises(K["attn_bwd_dkv"],
                             (lambda: K["attn_bwd_dkv"](good, good, good, bad, lse, lse, 0.125),),
                             "attn_bwd_dkv")


def int8_and_winograd(K, cases, shapes, randn, detail):
    """w8a8_matmul at the int8 path's shapes and tests/test_quant.py's;
    winograd_conv3x3 (no path calls it) at tests/test_winograd.py's shapes
    and at the UNet's 3x3 stride-1 shapes. Checked in f32 and bf16, timed
    with bf16 inputs (Winograd in f32 too). Each call must take the body its
    rule names (`w8a8_tc_body`, `wino_tc_body`): the tensor-core one at
    every int8-path and UNet shape and for Winograd in both types, the
    CUDA-core one for the ragged GEMMs. w8a8_matmul is timed in f32 too
    (the `f32` field). Winograd is timed as the whole
    wrapper (U = G w G^T by its kernel, then the convolution: the `ms` of
    the kernels line, as before) and, in bf16, as the kernel alone (`launch`
    on a prepared U), both beside cuDNN. With `detail`, each shape's row
    also splits one call's device time by kernel."""
    from tango_tpu_torch.ops import winograd as wg
    from tango_tpu_torch.ops.int8_gemm import quantize_rows, w8a8_matmul_plain, w8a8_tc_body
    from tango_tpu_torch.ops.quant import int_mm_ok, quantize_weight

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    w8a8_tol = {"f32": (1e-5, 1e-5), "bf16": (1e-2, 8e-3)}
    m, k, n = W8A8_TEST_SHAPE
    gemms = sorted(shapes["w8a8_matmul"] | {((m, k), (n, k))})
    w8a8 = K["w8a8_matmul"]
    for (m, k), (n, _) in gemms:
        case = cases["w8a8_matmul"]
        q, s = quantize_weight(randn(n, k, scale=k**-0.5), out_axis=0)
        for tag, dt in dtypes.items():
            x = randn(m, k, dtype=dt)
            what = f"w8a8_matmul ({m}, {k}, {n}) {tag}"
            out = took(cases["w8a8_matmul"], w8a8, w8a8_tc_body(k), lambda: w8a8(x, q, s), what)
            case.add_err(tag, assert_close(out, w8a8_matmul_plain(x, q, s), *w8a8_tol[tag], what))
        xq, _ = quantize_rows(x)
        lib = cuda_ms(lambda: torch._int_mm(xq, q.t())) if int_mm_ok(m, k, n) else None
        wl = randn(n, k, dtype=x.dtype, scale=k**-0.5)
        linear = cuda_ms(lambda: F.linear(x, wl))
        case.notes["linear_bf16_ms"] = case.notes.get("linear_bf16_ms", 0.0) + linear
        case.add_time(cuda_ms(lambda: w8a8(x, q, s)),
                      plain_cuda_ms(lambda: w8a8_matmul_plain(x, q, s)), lib,
                      *bound_ms(2 * m * k + n * k + 4 * n + 2 * m * n, 2 * m * n * k, INT8_OPS),
                      [[m, k], [n, k]], flops=2 * m * n * k, linear_bf16_ms=linear,
                      **({"by_kernel_ms": device_ms(lambda: w8a8(x, q, s), 20)} if detail else {}))
        x32 = randn(m, k)
        xq32, _ = quantize_rows(x32)
        case.add_time_f32(cuda_ms(lambda: w8a8(x32, q, s)),
                          plain_cuda_ms(lambda: w8a8_matmul_plain(x32, q, s)),
                          cuda_ms(lambda: torch._int_mm(xq32, q.t())) if int_mm_ok(m, k, n)
                          else None,
                          *bound_ms(4 * m * k + n * k + 4 * n + 4 * m * n, 2 * m * n * k,
                                    INT8_OPS), [[m, k], [n, k]], flops=2 * m * n * k)

    for m, k, n in W8A8_RAGGED + W8A8_TC_RAGGED:
        q, s = quantize_weight(randn(n, k, scale=k**-0.5), out_axis=0)
        for tag, dt in dtypes.items():
            x = randn(m, k, dtype=dt)
            what = f"w8a8_matmul ({m}, {k}, {n}) {tag}"
            out = took(cases["w8a8_matmul"], w8a8, w8a8_tc_body(k), lambda: w8a8(x, q, s), what)
            cases["w8a8_matmul"].add_err(tag, assert_close(
                out, w8a8_matmul_plain(x, q, s), *w8a8_tol[tag], what))

    wino_tol = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 2e-2)}
    # the U kernel against its torch version: the same f32 sums of halves (in
    # another order at most), rounded to the type: within a few f32 ulps of
    # |U| <= ~0.1 in f32, one bf16 step in bf16
    u_tol = {"f32": (1e-7, 1e-6), "bf16": (0.0, 2**-7)}
    convs = set(shapes["winograd_conv3x3"])
    convs |= {((b, ci, h, w), (co, ci, 3, 3)) for b, h, w, ci, co in WINO_TEST_SHAPES}
    checked_only = {((b, ci, h, w), (co, ci, 3, 3)) for b, h, w, ci, co in WINO_TC_RAGGED}
    wino = K["winograd_conv3x3"]
    for xshape, wshape in sorted(convs | checked_only):
        case = cases["winograd_conv3x3"]
        b, ci, h, w_ = xshape
        co = wshape[0]
        wt = randn(*wshape, scale=(9 * ci) ** -0.5)
        for tag, dt in dtypes.items():
            x = randn(*xshape, dtype=dt)
            what = f"winograd_conv3x3 {xshape} -> {co} {tag}"
            out = took(case, wino, wg.wino_tc_body(dt), lambda: wino(x, wt), what)
            case.add_err(tag, assert_close(out, wg.winograd_conv3x3_plain(x, wt), *wino_tol[tag],
                                           what))
            u = wg.kernel_weight(wt, dt)
            assert_close(wg.weight_tc(wt, dt), u, *u_tol[tag],
                         f"winograd_conv3x3 U of {wshape} {tag}")
        wl = wt.to(x.dtype)
        if (xshape, wshape) in checked_only:
            continue
        alone = cuda_ms(lambda: wg.launch(x, u, co))
        case.notes["kernel_only_ms"] = case.notes.get("kernel_only_ms", 0.0) + alone
        nbytes = (b * ci * h * w_ + b * co * h * w_ + 16 * ci * co) * x.element_size()
        flops = 2 * 4 * b * h * w_ * co * ci
        case.add_time(cuda_ms(lambda: wino(x, wt)),
                      plain_cuda_ms(lambda: wg.winograd_conv3x3_plain(x, wt)),
                      cuda_ms(lambda: F.conv2d(x, wl, padding=1)),
                      *bound_ms(nbytes, flops, BF16_FLOPS),
                      [list(xshape), list(wshape)], flops=flops, kernel_only_ms=alone,
                      **({"by_kernel_ms": device_ms(lambda: wino(x, wt), 20)} if detail else {}))
        # f32 (the 3xTF32 body) in the `f32` field, beside cuDNN at f32's
        # precision (without TF32, which cuDNN's f32 convolutions use by
        # default), bounded as 3xTF32 products
        x32 = randn(*xshape)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib32 = cuda_ms(lambda: F.conv2d(x32, wt, padding=1))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        case.add_time_f32(cuda_ms(lambda: wino(x32, wt)),
                          plain_cuda_ms(lambda: wg.winograd_conv3x3_plain(x32, wt)), lib32,
                          *bound_ms(2 * nbytes, flops, F32_TC_FLOPS),
                          [list(xshape), list(wshape)], flops=flops)


def limit_checks(K, cases, randn, tol, attn_tol, gn_bwd_tol, attn_bwd_tol):
    """Each kernel at one shape past the launch limits the port's wrappers
    used to have (a grid.y of 65535 rows or heads, 2^31 elements): checked
    against the plain version, not timed (no path launches these shapes)."""
    from tango_tpu_torch.ops.flash_attention import (
        attn_fwd_bias_plain,
        attn_fwd_plain,
        attn_fwd_v2_plain,
    )
    from tango_tpu_torch.ops.gn_silu import (
        gn_apply_plain,
        gn_bwd_cluster_size,
        gn_fwd_cluster_size,
        gn_silu_bwd_plain,
        gn_silu_fwd_plain,
        gn_stats_plain,
        n_chunks,
    )

    bf16 = torch.bfloat16
    # LIMIT_ROWS_SHAPE: gn_apply's B*C rows and gn_stats' B*G*chunks blocks
    nb, c, h, w = LIMIT_ROWS_SHAPE
    x = randn(nb, c, h, w, dtype=bf16, scale=2.0, loc=0.5)
    chunks = n_chunks(h * w)
    cases["gn_stats"].add_err("bf16", assert_close(
        K["gn_stats"](x, 32, chunks), gn_stats_plain(x, 32, chunks), 0.0, 1e-4,
        f"gn_stats {LIMIT_ROWS_SHAPE}"))
    a, b = randn(nb, c, scale=0.3, loc=1.0), randn(nb, c, scale=0.1)
    cases["gn_apply"].add_err("bf16", assert_close(
        K["gn_apply"](x, a, b, "silu"), gn_apply_plain(x, a, b, "silu"), *tol["bf16"],
        f"gn_apply {LIMIT_ROWS_SHAPE}"))
    del x

    # LIMIT_GN_SHAPE in bf16 through the two-stage kernels, and the same bytes
    # as (4B, C, H/4, W) (an 8 MB f32 sample at the full shape) through the
    # single pass and the backward. The plain versions run 16 samples at a
    # time; GroupNorm is per sample.
    nb, c, h, w = LIMIT_GN_SHAPE
    x = randn(nb, c, h, w, dtype=bf16, scale=2.0, loc=0.5)
    chunks = n_chunks(h * w)
    gam, bet = randn(c, scale=0.2, loc=1.0), randn(c, scale=0.1)
    a, b = randn(nb, c, scale=0.3, loc=1.0), randn(nb, c, scale=0.1)

    def sliced(out, plain, n, atol, rtol, what):
        return max(assert_close(out[i:i + 16], plain(i), atol, rtol, what)
                   for i in range(0, n, 16))

    cases["gn_stats"].add_err("bf16", sliced(
        K["gn_stats"](x, 32, chunks), lambda i: gn_stats_plain(x[i:i + 16], 32, chunks), nb,
        0.0, 1e-4, f"gn_stats {LIMIT_GN_SHAPE}"))
    cases["gn_apply"].add_err("bf16", sliced(
        K["gn_apply"](x, a, b, "silu"),
        lambda i: gn_apply_plain(x[i:i + 16], a[i:i + 16], b[i:i + 16], "silu"), nb,
        *tol["bf16"], f"gn_apply {LIMIT_GN_SHAPE}"))
    xs = x.view(4 * nb, c, h // 4, w)
    r = gn_fwd_cluster_size(bf16, *xs.shape[:2], math.prod(xs.shape[2:]), 32)
    y = took(cases["gn_silu_fwd"], K["gn_silu_fwd"], r > 0,
             lambda: K["gn_silu_fwd"](xs, gam, bet, 32, 1e-5, "silu"),
             f"gn_silu_fwd {tuple(xs.shape)}", body="cluster")
    cases["gn_silu_fwd"].add_err("bf16", sliced(
        y, lambda i: gn_silu_fwd_plain(xs[i:i + 16], gam, bet, 32, 1e-5, "silu"), 4 * nb,
        *tol["bf16"], f"gn_silu_fwd {tuple(xs.shape)}"))
    del y
    r = gn_bwd_cluster_size(bf16, *xs.shape[:2], math.prod(xs.shape[2:]), 32)
    dx, dgam, dbet = took(cases["gn_silu_bwd"], K["gn_silu_bwd"], r > 0,
                          lambda: K["gn_silu_bwd"](xs, xs, gam, bet, 32, 1e-5, "silu"),
                          f"gn_silu_bwd {tuple(xs.shape)}", body="cluster")
    parts = [gn_silu_bwd_plain(xs[i:i + 16], xs[i:i + 16], gam, bet, 32, 1e-5, "silu")
             for i in range(0, 4 * nb, 16)]
    what = f"gn_silu_bwd {tuple(xs.shape)}"
    cases["gn_silu_bwd"].add_err("bf16", max(
        assert_close(dx[i * 16:(i + 1) * 16], p[0], *gn_bwd_tol["bf16"], f"{what} dx")
        for i, p in enumerate(parts)))
    # the per-channel sums over B*H*W elements (2^24 at the full shape, up to
    # ~10^7): relative limits, and left out of the absolute error reported
    assert_close(dgam, sum(p[1] for p in parts), 0.0, 1e-3, f"{what} dgamma")
    assert_close(dbet, sum(p[2] for p in parts), 0.0, 1e-3, f"{what} dbeta")
    del x, xs, dx, parts
    torch.cuda.empty_cache()

    # LIMIT_HEADS heads of 64 tokens at head dim 8 (the smallest the kernels
    # take, which no main-path shape uses), f32, every attention kernel
    bh, s, d = LIMIT_HEADS, 64, 8
    q, k, v, do = (randn(bh, s, d) for _ in range(4))
    cases["attn_fwd"].add_err("f32", assert_close(
        K["attn_fwd"](q, k, v, d**-0.5), attn_fwd_plain(q, k, v, d**-0.5), *attn_tol["f32"],
        f"attn_fwd {bh} heads"))
    cases["attn_fwd_v2"].add_err("f32", assert_close(
        K["attn_fwd_v2"](q, k, v, d**-0.5), attn_fwd_v2_plain(q, k, v, d**-0.5),
        *attn_tol["f32"], f"attn_fwd_v2 {bh} heads"))
    bias = torch.where(torch.arange(s, device=q.device) < 40, 0.0, -10000.0)
    bias = bias.expand(bh // 2, 1, s).contiguous()
    cases["attn_fwd_bias"].add_err("f32", assert_close(
        K["attn_fwd_bias"](q, k, v, bias, 2, d**-0.5),
        attn_fwd_bias_plain(q, k, v, bias, 2, d**-0.5), *attn_tol["f32"],
        f"attn_fwd_bias {bh} heads"))
    check_bwd(K, cases, q, k, v, do, d**-0.5, attn_bwd_tol["f32"], (1e-4, 1e-3),
              f"{bh} heads f32")


# the counters of the GroupNorm kernels' redesigned bodies, which every
# path's shape takes: the thread-block-cluster bodies (gn_silu_fwd,
# gn_silu_bwd, gn_bwd_stats) and gn_bwd_apply's flat body. The per-path
# `cluster` dicts below hold both kinds under the kernel's name.
BODY_COUNTERS = ("cluster_launches", "flat_launches")


def body_counter(fn):
    """The name of fn's redesigned-body counter, None where it has none."""
    return next((c for c in BODY_COUNTERS if hasattr(fn, c)), None)


def cluster_counts(ops) -> dict:
    """Launches of each GroupNorm kernel that took its redesigned body
    (`body_counter`)."""
    return {n: getattr(fn, body_counter(fn)) for n, fn in ops.all_kernels().items()
            if body_counter(fn)}


def off_cluster(cluster: dict, launches: dict) -> list:
    """A problem for each kernel of `cluster` (its launches on the cluster or
    flat body) that a counted path launched off that body: every path's
    shape takes it."""
    return [f"{launches[n] - c} of {launches[n]} {n} launches off its cluster or flat body"
            for n, c in cluster.items() if c != launches[n]]


def tc_fields(fn, tc_by_path, cluster_by_path) -> dict:
    """The kernels line's extra fields of the kernels with a tensor-core body
    (`source`): its launches on the counted paths, and the source of the
    CUDA-core body that runs what it does not take (attention: other head
    dims; w8a8_matmul: K % 16 != 0; winograd_conv3x3 has none); of
    gn_silu_fwd, gn_silu_bwd, gn_bwd_stats (cluster_launches) and
    gn_bwd_apply (flat_launches), their launches on that body over the
    counted paths."""
    if body_counter(fn):
        return {body_counter(fn): sum(c.get(fn.__name__, 0) for c in cluster_by_path.values())}
    if not hasattr(fn, "tc_launches"):
        return {}
    fields = {"tc_launches": sum(tc.get(fn.__name__, 0) for tc in tc_by_path.values())}
    if hasattr(fn, "core_source"):  # winograd_conv3x3 has no CUDA-core body
        fields["core_source"] = fn.core_source
    return fields


def hand_kernel_names() -> set:
    """The __global__ functions of tango_tpu_torch/csrc/*.cu: the port's own
    kernels, as a trace names them."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tango_tpu_torch", "csrc")
    names = set()
    for f in os.listdir(csrc):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                                        r"\([^()]*\))*\)\s+)?(\w+)\s*\(", fh.read()))
    return names


def trace_phase(evaluate, launches: int) -> None:
    """Line `trace`: tango_tpu_torch.utils.profiling.trace around one bf16
    UNet evaluation (the per_eval one, CFG batch 2), its chrome trace read
    back: the CUDA kernel events, and those of the port's own kernels by
    name (`hand_kernel_names`), which must number the evaluation's
    `launches` of the port's wrappers (one kernel a launch); the trace's
    directory under build/ deleted after."""
    from tango_tpu_torch.utils.profiling import trace

    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.perf_counter()
    with torch.inference_mode(), trace(logdir) as d:
        evaluate()
    files = [f for f in os.listdir(d) if f.endswith(".json")]
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(logdir)
    ours = hand_kernel_names()
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    hand = collections.Counter(n for k in kernels for n in ours
                               if re.search(rf"\b{n}\b", k))
    log("trace", card=nvidia_smi(), files=len(files), events=len(events),
        cuda_kernel_events=len(kernels), hand_kernel_events=sum(hand.values()),
        wrapper_launches=launches, hand_kernels=dict(sorted(hand.items())),
        seconds=round(time.perf_counter() - t0, 3))
    if len(files) != 1 or not hand or sum(hand.values()) != launches:
        raise AssertionError(f"trace: {len(files)} trace files, {sum(hand.values())} events of "
                             f"the port's kernels for {launches} launches ({dict(hand)})")


def demo_phase(root: str) -> None:
    """Line `demo_torch`: `python examples/demo_torch.py --tiny` (on the card,
    its default) in a child process in an empty directory under build/; it
    must exit 0 and write a 16 kHz, non-silent demo_tiny.wav. The directory
    is deleted after."""
    from tango_tpu_torch.audio.wav import read_wav

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                       "examples", "demo_torch.py"), "--tiny"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    path = os.path.join(root, "demo_tiny.wav")
    wav, sr = read_wav(path) if out.returncode == 0 and os.path.exists(path) else (None, None)
    shutil.rmtree(root)
    log("demo_torch", rc=out.returncode, seconds=round(seconds, 3), stdout=out.stdout.strip(),
        samples=None if wav is None else len(wav), sr=sr,
        peak=None if wav is None else float(abs(wav).max()))
    if wav is None or sr != 16000 or not abs(wav).max() > 0:
        raise AssertionError(f"examples/demo_torch.py --tiny: rc {out.returncode}, "
                             f"{out.stderr[-2000:]}")


def int8_order_phase(C, quantized) -> None:
    """The int8 quantize order on the card (`cast_params`): from one seeded
    f32 UNet, quant="all" with cast_params=False (JAX's `from_components`:
    the f32 weights quantized) and True (cast to bf16 first, as `Tango()`).
    Logs the int8 weights that differ between the two, the scales that do,
    and the relative L2 between the latents of one 2-step generate in each
    order (JAX's end-to-end bar for the int8 mode is 0.05)."""
    from tango_tpu_torch.models.unet import UNet2DConditionModel
    from tango_tpu_torch.utils.init import init_random_

    with torch.device("meta"):
        unet = UNet2DConditionModel(C.TANGO_UNET)
    unet = init_random_(unet.to_empty(device=DEVICE), torch.Generator(device=DEVICE).manual_seed(7))
    f32_params = unet.state_dict()
    del unet
    int8, latents = [], []
    for cast in (False, True):
        t = quantized("all", unet_params=f32_params, cast_params=cast)
        sd = t.model.unet.state_dict()
        int8.append({k: v for k, v in sd.items() if v.dtype == torch.int8 or
                     k.endswith("weight_scale")})
        latents.append(t.sample_latents([PROMPT], 2, 3.0, 1, 0).float())
        del t, sd
    del f32_params
    weights = [k for k, v in int8[0].items() if v.dtype == torch.int8]
    flips = sum(int((int8[0][k] != int8[1][k]).sum()) for k in weights)
    total = sum(int8[0][k].numel() for k in weights)
    scales = [k + "_scale" for k in weights]
    rel = ((latents[0] - latents[1]).norm() / latents[0].norm()).item()
    finite = all(bool(torch.isfinite(x).all()) for x in latents)
    log("int8_order", int8_weights=total, flips=flips, flip_share=flips / total,
        scales_differing=sum(int((int8[0][k] != int8[1][k]).sum()) for k in scales),
        scales=sum(int8[0][k].numel() for k in scales),
        max_scale_rel_diff=max(((int8[0][k] - int8[1][k]).abs() / int8[0][k]).max().item()
                               for k in scales),
        latents_rel_l2=rel, jax_bar=0.05, finite=finite)
    if not finite:
        raise AssertionError("int8 quantize order: non-finite latents")
    del int8, latents
    torch.cuda.empty_cache()


def reference_vae_state_dict(vae_sd: dict, vocoder_sd: dict) -> dict:
    """The port's serving VAE (decode side) and HiFi-GAN state dicts under
    AudioLDM's names, f32 on the host, the vocoder under `vocoder.` and
    weight-normed as released (`weight_g` = ||w|| over every dimension but
    0, `weight_v` = w), so that loading folds it. Builds the smoke's test
    snapshot, nothing else."""
    rules = ((r"\b(down|up)_(\d+)_(block|attn)_(\d+)\.", r"\1.\2.\3.\4."),
             (r"\b(down|up)_(\d+)_(downsample|upsample)\.", r"\1.\2.\3."),
             (r"\bmid_(block_1|block_2|attn_1)\.", r"mid.\1."),
             (r"^ups_(\d+)\.", r"ups.\1."),
             (r"^resblocks_(\d+)\.convs([12])_(\d+)\.", r"resblocks.\1.convs\2.\3."))

    def rename(k):
        for rx, rep in rules:
            k = re.sub(rx, rep, k)
        return k

    out = {rename(k): v.detach().to("cpu", torch.float32) for k, v in vae_sd.items()}
    for k, v in vocoder_sd.items():
        w, k = v.detach().to("cpu", torch.float32), "vocoder." + rename(k)
        if k.endswith(".weight"):
            out[k + "_g"] = w.norm(dim=tuple(range(1, w.dim())), keepdim=True)
            out[k + "_v"] = w
        else:
            out[k] = w
    return out


def random_encoder(C, seed: int) -> dict:
    """Seeded random weights of TANGO_VAE's encoder and quant_conv (the
    serving pipeline has none), for the snapshot's VAE bin."""
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.utils.init import init_random_

    with torch.device("meta"):
        vae = AutoencoderKL(C.TANGO_VAE, with_encoder=True)
    vae = init_random_(vae.to_empty(device=DEVICE), torch.Generator(device=DEVICE).manual_seed(seed))
    return {k: v for k, v in vae.state_dict().items() if k.startswith(("encoder.", "quant_conv."))}


def released_vae_config(C) -> dict:
    """TANGO_VAE as a released vae_config.json has it: the geometry nested in
    `ddconfig`."""
    vae = C.TANGO_VAE.to_dict()
    return {"embed_dim": vae.pop("embed_dim"), "scale_factor": vae.pop("scale_factor"),
            "ddconfig": vae}


def write_snapshot(root: str, C, tango, encoder: dict) -> dict:
    """A full-width reference-format snapshot of pipeline `tango`'s weights
    in `root`: the main bin through the port's `save_main_bin`, the VAE bin
    (the decoder, the `encoder` state dict's encoder and quant_conv, as
    released snapshots ship them, and the vocoder) through
    `reference_vae_state_dict`, and the four JSON configs (the VAE's
    geometry nested in `ddconfig`, as released). Returns bytes and seconds."""
    from tango_tpu_torch.utils.export import save_main_bin

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    save_main_bin(os.path.join(root, "pytorch_model_main.bin"), tango.model.unet.state_dict(),
                  tango.t5.state_dict())
    torch.save(reference_vae_state_dict({**tango.vae.state_dict(), **encoder},
                                        tango.vocoder.state_dict()),
               os.path.join(root, "pytorch_model_vae.bin"))
    unet = {k: v for k, v in C.TANGO_UNET.to_dict().items() if not k.startswith("quant_")}
    configs = {
        "main_config.json": {"text_encoder_name": "google/flan-t5-large",
                             "scheduler_name": "stabilityai/stable-diffusion-2-1",
                             "unet_model_config_path": "unet_config.json"},
        "vae_config.json": released_vae_config(C),
        "unet_config.json": {"_class_name": "UNet2DConditionModel", "act_fn": "silu", **unet},
        "stft_config.json": C.TANGO_STFT.to_dict(),
    }
    for name, cfg in configs.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(cfg, f, indent=2)
    seconds = time.perf_counter() - t0
    sizes = {n: os.path.getsize(os.path.join(root, n)) for n in sorted(os.listdir(root))}
    return {"write_s": round(seconds, 3), "bytes": sum(sizes.values()),
            "bin_bytes": {n: b for n, b in sizes.items() if n.endswith(".bin")}}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element of x (8 significand bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0**-126)))
    return torch.exp2(e - 7)


def compare_loaded(tango, loaded) -> dict:
    """The loaded pipeline's parameters against the pipeline it was written
    from: the UNet, T5 and VAE bit-equal (bf16 -> f32 -> bf16 is exact), the
    vocoder within one bf16 step (the weight-norm fold). Raises otherwise."""
    return compare_modules([(name, *(t.model.unet if name == "unet" else getattr(t, name)
                                     for t in (tango, loaded)), name != "vocoder")
                            for name in ("unet", "t5", "vae", "vocoder")])


def cli_phase(root: str, snapshot: str, wav_len: int) -> dict:
    """`tango_tpu_torch.inference.main` on the snapshot, in `root` (its
    summary.jsonl goes to the working directory): 3 prompts, 2 steps, batch
    2; three non-silent int16 WAVs of wav_len samples and one record."""
    import wave

    import numpy as np

    from tango_tpu_torch import inference

    os.makedirs(root, exist_ok=True)
    manifest = os.path.join(root, "prompts.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps({"location": f"x{i}.wav", "captions": c}) + "\n"
                        for i, c in enumerate(BATCH_PROMPTS)))
    out_dir = os.path.join(root, "out")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        inference.main(["--model", snapshot, "--test_file", manifest, "--output_dir", out_dir,
                        "--num_steps", str(CLI_STEPS), "--batch_size", str(CLI_BATCH)])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    problems, peaks = [], []
    for i in range(len(BATCH_PROMPTS)):
        with wave.open(os.path.join(out_dir, f"output_{i}.wav")) as w:
            if (w.getsampwidth(), w.getnchannels(), w.getframerate()) != (2, 1, 16000):
                problems.append(f"output_{i}.wav is not 16 kHz mono int16")
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        peaks.append(int(np.abs(pcm.astype(np.int32)).max()) if pcm.size else 0)
        if pcm.size != wav_len or peaks[-1] == 0:
            problems.append(f"output_{i}.wav: {pcm.size} samples, peak {peaks[-1]}")
    with open(os.path.join(root, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if len(records) != 1 or records[0]["num_prompts"] != len(BATCH_PROMPTS):
        problems.append(f"summary.jsonl: {records}")
    if problems:
        raise AssertionError("inference CLI: " + "; ".join(problems))
    return {"cli_s": round(seconds, 3), "cli_x_realtime": records[0]["x_realtime"],
            "cli_peaks": peaks}


def write_wavs(root: str, n: int, seconds: float, seed: int) -> str:
    """`n` seeded synthetic 16 kHz WAVs (a few partials and noise) and their
    JSON-lines manifest under `root`; returns the manifest's path."""
    import numpy as np

    from tango_tpu_torch.audio.wav import write_wav

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    rows = []
    for i in range(n):
        f0 = rng.uniform(80.0, 800.0)
        wav = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3))
                  for h in (1, 2, 3))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t))
        wav = wav + 0.02 * rng.standard_normal(t.shape)
        path = os.path.join(root, f"clip{i}.wav")
        write_wav(path, wav.astype(np.float32))
        rows.append({"dataset": "smoke", "location": path, "captions": TRAIN_CAPTIONS[i % 4]})
    manifest = os.path.join(root, "train.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def ingest_child(out: str) -> int:
    """Phase ingest's work, in a child process started with one BLAS thread:
    each fixture read INGEST_REPS times through the port's read_wav and held
    against JAX's decode in reference.npz; the record as JSON in `out`."""
    import numpy as np

    from tango_tpu_torch.audio import flac, flac_native, opus
    from tango_tpu_torch.audio.wav import read_wav, sniff_format
    from tango_tpu_torch.train.data import Example, validate_manifest

    ref = np.load(os.path.join(INGEST_DIR, "reference.npz"))
    libopus = opus.libopus_available()
    formats, problems = {}, []
    for name in INGEST_FORMATS:
        path = os.path.join(INGEST_DIR, f"clip.{name}")
        if sniff_format(path) != name:
            problems.append(f"{name}: sniffed as {sniff_format(path)!r}")
            continue
        if name == "opus" and not libopus:
            # JAX's behaviour: the preflight refuses an Opus manifest
            try:
                validate_manifest([Example(path, "opus")])
                refused = False
            except ValueError as e:
                refused = "libopus" in str(e)
            formats[name] = {"preflight_refused": refused}
            if not refused:
                problems.append("opus without libopus: the preflight did not refuse it")
            continue
        subframes = dict(flac.SUBFRAMES)
        times = []
        for _ in range(INGEST_REPS):
            t0 = time.perf_counter()
            pcm, rate = read_wav(path)
            times.append(time.perf_counter() - t0)
        if name in INGEST_EXACT:
            want, limit = ref[f"{name}_int16"].astype(np.float32) / 32768.0, 0.0
        else:
            want, limit = ref[f"{name}_f32"], INGEST_LIMIT
        channels = 1 if pcm.ndim == 1 else pcm.shape[1]
        rec = {"rate": rate, "channels": channels, "audio_s": len(pcm) / rate,
               "file_bytes": os.path.getsize(path), "decode_s": times,
               "audio_s_per_s": len(pcm) / rate / min(times),
               "msamples_per_s": len(pcm) * channels / min(times) / 1e6, "limit": limit}
        if pcm.dtype != np.float32 or pcm.shape != want.shape or rate != int(ref[f"{name}_rate"]):
            problems.append(f"{name}: {pcm.dtype} {pcm.shape} at {rate} Hz, JAX's float32 "
                            f"{want.shape} at {int(ref[f'{name}_rate'])} Hz")
        else:
            rec["max_abs_err"] = float(np.abs(pcm.astype(np.float64) - want).max())
            if rec["max_abs_err"] > limit:
                problems.append(f"{name}: {rec['max_abs_err']} from JAX's decode (limit {limit})")
        if name == "flac":
            rec["subframes"] = {k: v - subframes[k] for k, v in flac.SUBFRAMES.items()}
            rec["path"] = "native" if rec["subframes"]["python"] == 0 else "python"
            rec["native_build"] = flac_native.build_info
        formats[name] = rec
    with open(out, "w") as f:
        json.dump({"libopus": libopus, "formats": formats, "problems": problems}, f)
    return 0


def ingest_phase(out: str) -> dict:
    """Phase ingest: `ingest_child` in a process of its own with one BLAS
    thread (OMP, OpenBLAS and MKL), so that the rates are one host thread's;
    its record logged. Returns the record."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--ingest", out], env=env,
                   check=True, timeout=300)
    with open(out) as f:
        rec = json.load(f)
    os.remove(out)
    log("ingest", seconds=round(time.perf_counter() - t0, 3), reps=INGEST_REPS, **rec)
    if rec["problems"]:
        raise AssertionError("ingest: " + "; ".join(rec["problems"]))
    return rec


def mix_formats(manifest: str, libopus: bool) -> list:
    """Point the first rows of `manifest` (write_wavs') at copies of the
    ingest fixtures, one a format (Opus only where libopus loads), beside
    the WAVs, which stay on the disk; returns each row's file extension."""
    names = [n for n in INGEST_FORMATS if n != "opus" or libopus]
    with open(manifest) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for row, name in zip(rows, names):
        dst = os.path.splitext(row["location"])[0] + f".{name}"
        shutil.copyfile(os.path.join(INGEST_DIR, f"clip.{name}"), dst)
        row["location"] = dst
    with open(manifest, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return [os.path.splitext(r["location"])[1][1:] for r in rows]


def watched_loader(waits: dict, decoded: dict):
    """Record, on train/data.py's loader, the seconds the consumer waited for
    each batch (waits["train" or "validation"]) and each file's decode
    outcome (decoded[extension] -> [ok, ...]); returns the undo function."""
    from tango_tpu_torch.train import data

    loader_iter, decode_one = data.FeaturizedLoader.__iter__, data._decode_one

    def timed_iter(self):
        gen = loader_iter(self)
        key = "train" if self.shuffle else "validation"
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                waits.setdefault(key, []).append(round(time.perf_counter() - t0, 4))
                yield item
        finally:
            gen.close()

    def recorded_decode(args):
        out = decode_one(args)
        decoded.setdefault(os.path.splitext(args[0])[1][1:], []).append(out is not None)
        return out

    data.FeaturizedLoader.__iter__, data._decode_one = timed_iter, recorded_decode

    def undo():
        data.FeaturizedLoader.__iter__, data._decode_one = loader_iter, decode_one
    return undo


def read_counters(ops) -> tuple[dict, dict, dict, dict]:
    """Every kernel's launches and launched shapes, and the tensor-core and
    cluster launches of the kernels with such bodies."""
    kernels = ops.all_kernels()
    return ({n: fn.launches for n, fn in kernels.items()},
            {n: set(fn.shapes) for n, fn in kernels.items()},
            {n: fn.tc_launches for n, fn in kernels.items() if hasattr(fn, "tc_launches")},
            cluster_counts(ops))


def tc_problems(path: str, launches: dict, tc: dict) -> list:
    """Launches off the body `path` must take: on a path of CORE_ATTN_PATHS
    every attention launch on its CUDA-core body (tensor-core launches 0),
    elsewhere every launch of a kernel that has a tensor-core body on it."""
    core = path in CORE_ATTN_PATHS
    want = {n: 0 if core and n.startswith("attn_") else launches[n] for n in tc}
    off = {n: (launches[n], tc[n]) for n in tc if tc[n] != want[n]}
    if not off:
        return []
    return [f"launches off the {'CUDA-core' if core else 'tensor-core'} body "
            f"(launches, tensor-core): {off}"]


def body_problems(path: str, launches: dict, tc: dict, cluster: dict) -> list:
    """A counted path's launch problems: a kernel of PATH_KERNELS[path] that
    never launched; an attention launch off the body the path's head dim
    takes (`tc_problems`: the tensor-core one, every launch of the training
    paths, forward and backward, f32, at D = 64); a GroupNorm off its
    cluster body."""
    problems = []
    idle = [n for n in PATH_KERNELS[path] if launches[n] == 0]
    if idle:
        problems.append(f"kernels never launched on the {path} path: {idle}")
    return problems + tc_problems(path, launches, tc) + off_cluster(cluster, launches)


def wav_samples(body: bytes):
    """A WAV response's int16 samples; raises unless it is 16 kHz mono int16."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        fmt = (w.getsampwidth(), w.getnchannels(), w.getframerate())
        if fmt != (2, 1, 16000):
            raise AssertionError(f"response WAV (width, channels, rate) {fmt}: expected "
                                 "16 kHz mono int16")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def http(port: int, path: str, body: bytes | None = None, timeout: float = 300.0):
    """One request to the server on 127.0.0.1 -> (status, content type, body,
    seconds); a POST when `body` is given."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = (r.status, r.headers["Content-Type"], r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers["Content-Type"], e.read())
    return (*out, time.perf_counter() - t0)


def serve_http_phase(snap_dir: str, counted, instrument, expect_len: int):
    """`serve.BatchingPredictor(max_batch=4)` set up on the snapshot (bf16 on
    the card; the load and the two warm-ups timed), `serve_http` on
    127.0.0.1 at port 0 in a thread. Counted as path `serve_http`: GET
    /healthz, 4 concurrent unseeded POST /generate at STEPS steps, which must
    ride one predict_batch and one generate_for_batch of batch 4, one seeded
    request, and two bad bodies (400). Then, uncounted, the seeded response
    must equal `generate` at that seed sample for sample. Returns counted's
    (launches, shapes)."""
    import threading

    import numpy as np

    from tango_tpu_torch import pipeline
    from tango_tpu_torch.serve import BatchingPredictor, serve_http

    timings, made, real = {}, [], pipeline.Tango

    def timed_tango(*a, **kw):
        """Tango(...), its construction and first generate / generate_for_batch
        (setup's warm-ups) timed."""
        t0 = time.perf_counter()
        t = real(*a, **kw)
        torch.cuda.synchronize()
        timings["load_s"] = round(time.perf_counter() - t0, 3)
        for name in ("generate", "generate_for_batch"):
            def timed(*args, _fn=getattr(t, name), _name=name, **kwargs):
                s0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                timings[f"warmup_{_name}_s"] = round(time.perf_counter() - s0, 3)
                return out
            setattr(t, name, timed)
        made.append(t)
        return t

    predictor = BatchingPredictor(max_batch=SERVE_BATCH)
    pipeline.Tango = timed_tango
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the default tokenizer's, checked in `snapshot`
            predictor.setup(snap_dir, device=DEVICE)
        timings["setup_s"] = round(time.perf_counter() - t0, 3)
    finally:
        pipeline.Tango = real
    tango = predictor.tango
    del tango.generate, tango.generate_for_batch  # the class's methods again
    batches, chunks = [], []
    predict_batch, generate_for_batch = predictor.predict_batch, tango.generate_for_batch

    def spy_predict_batch(prompts, **kw):
        batches.append(len(prompts))
        return predict_batch(prompts, **kw)

    def spy_generate_for_batch(prompts, **kw):
        chunks.append((len(prompts), kw.get("batch_size")))
        return generate_for_batch(prompts, **kw)

    predictor.predict_batch, tango.generate_for_batch = spy_predict_batch, spy_generate_for_batch
    server = serve_http(predictor, 0, "127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    remove = instrument(tango)
    latencies, seeded, bad = {}, {}, {}

    def drive():
        status = http(port, "/healthz")
        if status[:3] != (200, "text/plain", b"ok"):
            raise AssertionError(f"GET /healthz: {status[:3]}")
        results = {}

        def post(i, prompt):
            results[i] = http(port, "/generate",
                              json.dumps({"prompt": prompt, "steps": STEPS}).encode())

        threads = [threading.Thread(target=post, args=(i, p)) for i, p in enumerate(SERVE_PROMPTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or len(results) != len(SERVE_PROMPTS):
            raise AssertionError(f"{len(results)} of {len(SERVE_PROMPTS)} requests answered")
        st, ctype, body, sec = http(port, "/generate", json.dumps(
            {"prompt": PROMPT, "steps": STEPS, "seed": SERVE_SEED}).encode())
        seeded.update(status=st, ctype=ctype, body=body)
        for name, b in (("empty", b"{}"), ("not_json", b"not json")):
            bad[name] = http(port, "/generate", b)[0]
        outs = []
        for i, (st_i, ctype_i, body_i, sec_i) in sorted(results.items()):
            if (st_i, ctype_i) != (200, "audio/wav"):
                raise AssertionError(f"request {i}: {st_i} {ctype_i} {body_i[:200]!r}")
            latencies[f"request_{i}"] = round(sec_i, 3)
            outs.append(wav_samples(body_i))
        if (st, ctype) != (200, "audio/wav"):
            raise AssertionError(f"seeded request: {st} {ctype} {body[:200]!r}")
        latencies["seeded"] = round(sec, 3)
        outs.append(wav_samples(body))
        return outs, {"batched_requests": wall, "seeded_request": sec}

    def fields(launches):
        return dict(**timings, request_latency_s=latencies, predict_batch_sizes=batches,
                    generate_for_batch_calls=chunks, bad_body_status=bad)

    try:
        counted_out = counted("serve_http", drive, expect_len, extra=fields)
        problems = []
        if batches != [SERVE_BATCH] or chunks != [(SERVE_BATCH, SERVE_BATCH)]:
            problems.append(f"the {len(SERVE_PROMPTS)} requests rode predict_batch {batches} "
                            f"and generate_for_batch {chunks}: expected one batch of "
                            f"{SERVE_BATCH}")
        if bad != {"empty": 400, "not_json": 400}:
            problems.append(f"bad bodies answered {bad}, expected 400")
        want = tango.generate(PROMPT, steps=STEPS, seed=SERVE_SEED)
        got = wav_samples(seeded["body"])
        differ = int((got != want).sum()) if got.shape == want.shape else -1
        log("serve_http_seeded", samples=int(want.size), differ=differ,
            max_int16_diff=int(abs(got.astype("int32") - want.astype("int32")).max())
            if differ >= 0 else None)
        if differ:
            problems.append(f"the seeded response differs from generate at seed {SERVE_SEED} "
                            f"in {differ} samples (-1: in length)")
        if problems:
            raise AssertionError("serve_http: " + "; ".join(problems))
    finally:
        remove()
        server.shutdown()
        server.server_close()
        predictor.close()
    del predictor, tango, made, remove
    torch.cuda.empty_cache()
    return counted_out


def timed_methods(cls, names, times: dict):
    """Wrap methods `names` of `cls` to append each call's seconds (the card
    synchronized around it) to times[name]; returns the undo function."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(round(1e3 * (time.perf_counter() - s0), 3))
            return out
        return timed

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(cls, n, fn)
    return undo


def train_cli_phase(snap_dir: str, root: str, start: dict, ops) -> tuple:
    """`python -m tango_tpu_torch.train.cli`'s main on the snapshot (the VAE
    with its encoder from --tango_snapshot, the UNet and T5 from --hf_model)
    and the 8 clips of data/train.json (mix_formats': a clip of each format
    the port reads, WAVs for the rest): batch 2, accumulation 2, 2 updates,
    one epoch, validation on the first 2 clips, `best` kept. Every clip must
    decode (none replaced by the loader's constant stand-in); the seconds
    the trainer waited on the loader are logged. Counters zeroed just
    before main and read after. `start`: the snapshot's UNet weights.
    Returns (launches, shapes, tc, cluster)."""
    import numpy as np

    from tango_tpu_torch.train import cli, sft
    from tango_tpu_torch.utils.checkpoint import load_native

    manifest = os.path.join(root, "data", "train.json")
    val = os.path.join(root, "data", "val.json")
    out = os.path.join(root, "train_cli")
    with open(manifest) as f:
        formats = sorted({os.path.splitext(json.loads(line)["location"])[1][1:]
                          for line in f if line.strip()})
    times, waits, decoded = {}, {}, {}
    undo_steps = timed_methods(sft.SFTTrainer, ("train_step",), times)
    undo_loader = watched_loader(waits, decoded)
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the default tokenizer's
            state = cli.main(["--train_file", manifest, "--validation_file", val,
                              "--tango_snapshot", snap_dir, "--hf_model", snap_dir,
                              "--per_device_train_batch_size", str(TRAIN_BATCH),
                              "--gradient_accumulation_steps", "2", "--max_train_steps", "2",
                              "--num_train_epochs", "1", "--checkpointing_steps", "best",
                              "--output_dir", out, "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        undo_steps()
        undo_loader()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    problems = body_problems("train_cli", launches, tc, cluster)
    failed = {ext: v.count(False) for ext, v in decoded.items() if not all(v)}
    if failed or sorted(decoded) != formats:
        problems.append(f"decoded {sorted(decoded)} of the manifest's {formats}; the constant "
                        f"stand-in for {failed}")
    with open(os.path.join(out, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if (len(records) != 2 or set(records[0]) != {"args"}
            or not all(math.isfinite(records[1][k]) for k in ("train_loss", "val_loss"))):
        problems.append(f"summary.jsonl: {records}")
    if (state.step, state.opt_state.updates) != (4, 2):
        problems.append(f"{state.step} micro-steps, {state.opt_state.updates} updates: "
                        "expected 4, 2")
    best, _ = load_native(os.path.join(out, "best"))
    if set(best) != set(start):
        problems.append("the best checkpoint's keys are not the UNet's")
    elif all(torch.equal(best[k], start[k]) for k in start):
        problems.append("the best checkpoint equals the snapshot's UNet: no training happened")
    finite = all(bool(torch.isfinite(v).all()) for v in best.values())
    if not finite:
        problems.append("non-finite weights in the best checkpoint")
    log("train_cli", seconds=round(seconds, 3), peak_memory_bytes=peak,
        ms_per_micro_step=times.get("train_step"), loader_wait_s=waits,
        decoded={ext: len(v) for ext, v in sorted(decoded.items())}, records=records[1:],
        launches=launches, tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    del state, best
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("train_cli: " + "; ".join(problems))
    return launches, shapes, tc, cluster


def dpo_phase(snap_dir: str, root: str, start: dict, ops) -> tuple:
    """`python -m tango_tpu_torch.train.dpo_cli`'s main on the snapshot: a
    4-row preference manifest (chosen clips 0-3, rejected 4-7), batch 2,
    accumulation 1, 2 epochs of which 1 SFT-first, a 2-row validation file.
    Counters zeroed just before main and read after. Checks one `sft` and one
    `dpo` record, `last` and `best`, the reference UNet bit-equal to `start`
    (the snapshot's UNet) after the run, and every launch on its body.
    Returns (launches, shapes, tc, cluster)."""
    from tango_tpu_torch.train import dpo, dpo_cli

    rows = [{"captions": TRAIN_CAPTIONS[i], "chosen": os.path.join(root, "data", f"clip{i}.wav"),
             "rejected": os.path.join(root, "data", f"clip{i + 4}.wav")} for i in range(4)]
    prefs, val = os.path.join(root, "data", "prefs.json"), os.path.join(root, "data", "prefs_val.json")
    for path, part in ((prefs, rows), (val, rows[:2])):
        with open(path, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in part))
    out = os.path.join(root, "dpo")
    times = {}
    undo = timed_methods(dpo.DPOTrainer, ("dpo_step", "sft_step"), times)
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the default tokenizer's
            state, ref = dpo_cli.main(["--train_file", prefs, "--validation_file", val,
                                       "--tango_snapshot", snap_dir,
                                       "--per_device_train_batch_size", "2",
                                       "--gradient_accumulation_steps", "1",
                                       "--num_train_epochs", "2", "--sft_first_epochs", "1",
                                       "--output_dir", out, "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        undo()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    problems = body_problems("dpo", launches, tc, cluster)
    with open(os.path.join(out, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if [r["phase"] for r in records] != ["sft", "dpo"] or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["val_loss"]) for r in records):
        problems.append(f"summary.jsonl: {records}")
    elif not 0.0 <= records[1]["implicit_acc"] <= 1.0:
        problems.append(f"implicit_acc {records[1]['implicit_acc']}")
    missing = [n for n in ("last", "best") if not os.path.exists(os.path.join(out, n, "params"))]
    if missing:
        problems.append(f"checkpoints missing: {missing}")
    ref_sd = ref.state_dict()
    ref_differ = sum(int((ref_sd[k].cpu() != start[k]).sum()) for k in start)
    if set(ref_sd) != set(start) or ref_differ:
        problems.append(f"the reference UNet moved: {ref_differ} elements differ from the "
                        "snapshot's")
    if any(p.grad is not None for p in ref.parameters()):
        problems.append("the reference UNet has gradients")
    log("dpo", seconds=round(seconds, 3), peak_memory_bytes=peak,
        ms_per_dpo_micro_step=times.get("dpo_step"), ms_per_sft_micro_step=times.get("sft_step"),
        records=records, reference_elements_differ=ref_differ, updates=state.opt_state.updates,
        launches=launches, tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    del state, ref, ref_sd
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("dpo: " + "; ".join(problems))
    return launches, shapes, tc, cluster


# ---- phase tango2_eval: Tango 2's inference CLI with the CLAP score and the
# objective evaluation, and the batch CLI's CLAP re-ranking

def renamed(sd: dict, rules, prefix: str = "") -> dict:
    """`sd` on the host in f32 under released names: each key through the
    first of `rules` (regex, replacement) that matches, then `prefix`."""
    out = {}
    for k, v in sd.items():
        for rx, rep in rules:
            k, n = re.subn(rx, rep, k)
            if n:
                break
        out[prefix + k] = v.detach().to("cpu", torch.float32)
    return out


# the port's names -> LAION-CLAP's (text_branch: HF RobertaModel), Cnn14's
# and torchvggish's: the converters' rules run backwards
CLAP_TEXT_NAMES = (
    (r"^(word|position|token_type)_embeddings\.", r"text_branch.embeddings.\1_embeddings."),
    (r"^embeddings_ln\.", "text_branch.embeddings.LayerNorm."),
    (r"^layer_(\d+)\.attention\.(query|key|value)\.",
     r"text_branch.encoder.layer.\1.attention.self.\2."),
    (r"^layer_(\d+)\.attention\.output_dense\.",
     r"text_branch.encoder.layer.\1.attention.output.dense."),
    (r"^layer_(\d+)\.attention_ln\.", r"text_branch.encoder.layer.\1.attention.output.LayerNorm."),
    (r"^layer_(\d+)\.intermediate\.", r"text_branch.encoder.layer.\1.intermediate.dense."),
    (r"^layer_(\d+)\.output\.", r"text_branch.encoder.layer.\1.output.dense."),
    (r"^layer_(\d+)\.output_ln\.", r"text_branch.encoder.layer.\1.output.LayerNorm."),
    (r"^pooler\.", "text_branch.pooler.dense."),
    (r"^proj_(\d)\.", r"text_projection.\1."))
CLAP_AUDIO_NAMES = (
    (r"^htsat\.bn0\.(mean|var)$", r"audio_branch.bn0.running_\1"),
    (r"^htsat\.patch_(proj|norm)\.", r"audio_branch.patch_embed.\1."),
    (r"^htsat\.layer_(\d+)_block_(\d+)\.mlp_fc(\d)\.",
     r"audio_branch.layers.\1.blocks.\2.mlp.fc\3."),
    (r"^htsat\.layer_(\d+)_block_(\d+)\.", r"audio_branch.layers.\1.blocks.\2."),
    (r"^htsat\.layer_(\d+)_downsample\.", r"audio_branch.layers.\1.downsample."),
    (r"^htsat\.", "audio_branch."),
    (r"^proj_(\d)\.", r"audio_projection.\1."))
CNN14_NAMES = ((r"\.(mean|var)$", r".running_\1"),)
VGGISH_NAMES = (tuple((rf"^conv{i}\.", f"features.{t}.")
                     for i, t in enumerate((0, 3, 6, 8, 11, 13)))
                + tuple((rf"^fc{i}\.", f"embeddings.{t}.") for i, t in enumerate((0, 2, 4))))


def write_scorer_checkpoints(root: str) -> dict:
    """Seeded random full-width scorers written in their released formats
    under `root`: a LAION-CLAP `.pt` ({"state_dict": ...}: RoBERTa-base,
    HTSAT-tiny and both projections, the audio side under `module.`), Cnn14
    (527 classes) as {"model": sd}, and torchvggish's state dict. Each
    converts back bit-equal to the weights it was written from (checked).
    Returns the paths and the seconds and bytes written."""
    from tango_tpu_torch.eval.panns import Cnn14, convert_cnn14
    from tango_tpu_torch.eval.vggish import VGGish, convert_vggish
    from tango_tpu_torch.models.clap import ROBERTA_BASE, ClapTextEncoder, convert_clap_text
    from tango_tpu_torch.models.htsat import HTSAT_TINY, ClapAudioEncoder, convert_clap_audio
    from tango_tpu_torch.utils.init import init_random_

    def made(make, seed):
        with torch.device("meta"):
            m = make()
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return init_random_(m.to_empty(device=DEVICE), gen).state_dict()

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    text = made(lambda: ClapTextEncoder(ROBERTA_BASE), 11)
    audio = made(lambda: ClapAudioEncoder(HTSAT_TINY), 12)
    c14, vgg = made(Cnn14, 13), made(VGGish, 14)
    clap = {**renamed(text, CLAP_TEXT_NAMES), **renamed(audio, CLAP_AUDIO_NAMES, "module.")}
    cnn14, vggish = renamed(c14, CNN14_NAMES), renamed(vgg, VGGISH_NAMES)
    unprefixed = {k[len("module."):] if k.startswith("module.") else k: v for k, v in clap.items()}
    problems = [what for what, ours, back in (
        ("clap text", text, convert_clap_text(unprefixed)),
        ("clap audio", audio, convert_clap_audio(unprefixed, HTSAT_TINY)),
        ("cnn14", c14, convert_cnn14(cnn14)), ("vggish", vgg, convert_vggish(vggish)))
        if set(ours) != set(back) or any(not torch.equal(ours[k].cpu(), back[k]) for k in ours)]
    del text, audio, c14, vgg, unprefixed
    if problems:
        raise AssertionError(f"released-format checkpoints do not convert back: {problems}")
    paths = {n: os.path.join(root, f) for n, f in (("clap", "clap.pt"), ("cnn14", "cnn14.pth"),
                                                   ("vggish", "vggish.pth"))}
    torch.save({"state_dict": clap}, paths["clap"])
    torch.save({"model": cnn14}, paths["cnn14"])
    torch.save(vggish, paths["vggish"])
    return {"paths": paths, "write_s": round(time.perf_counter() - t0, 3),
            "bytes": {n: os.path.getsize(p) for n, p in paths.items()}}


def write_references(root: str, n: int, seconds: float, seed: int) -> str:
    """`n` seeded ground-truth WAVs named as the CLI's outputs (output_{i}.wav,
    the evaluation's pairing) in `root`."""
    manifest = write_wavs(root, n, seconds, seed)
    for i in range(n):
        os.replace(os.path.join(root, f"clip{i}.wav"), os.path.join(root, f"output_{i}.wav"))
    os.remove(manifest)
    return root


def read_int16(path: str):
    import wave

    import numpy as np

    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def card_vs_cpu(what: str, card, cpu, limit: float, scale: float = 1.0) -> dict:
    """Largest |card - cpu| over `scale` (1, or the CPU output's largest
    magnitude) against `limit`."""
    import numpy as np

    err = float(np.abs(np.asarray(card, np.float64) - np.asarray(cpu, np.float64)).max()) / scale
    return {"what": what, "err": err, "limit": limit, "ok": bool(err <= limit)}


def tango2_eval_phase(snap_dir: str, root: str, ops) -> tuple:
    """Phase `tango2_eval` on the snapshot, counted as one path (the counters
    zeroed just before the two CLI runs and read just after): seeded random
    full-width scorers written in their released formats and 4 reference
    WAVs; `inference_tango2.main` with --clap_ckpt, --reference_dir,
    --cnn14_ckpt and --vggish_ckpt (TANGO2_PROMPTS, STEPS steps, batch 4, the
    RoBERTa-id fallback tokenizer); `inference.main` with --num_samples 2
    and --clap_ckpt (batch 2). Checks JAX's record keys, a finite CLAP score
    in [-1, 1], finite metrics (IS NaN: its 10 splits need 10 clips, as in
    JAX), every tower's weights on the card, each re-ranked WAV its group's
    argmax of the similarity recomputed here, the generation's launches on
    their bodies; then, uncounted, the full-width towers (and HTSAT's latent
    map) on the card against the same modules on the CPU in f32
    (CARD_CPU_LIMITS). Returns (launches,
    shapes, tc, cluster)."""
    import numpy as np

    from tango_tpu_torch import inference, inference_tango2, pipeline
    from tango_tpu_torch.audio.wav import resample_poly
    from tango_tpu_torch.eval import evaluator
    from tango_tpu_torch.models.htsat import clap_logmel

    t_phase = time.perf_counter()
    ckpts = write_scorer_checkpoints(os.path.join(root, "scorers"))
    paths = ckpts["paths"]
    refs = write_references(os.path.join(root, "refs"), len(TANGO2_PROMPTS), 10.24, seed=5)
    manifest = os.path.join(root, "tango2.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps({"location": f"x{i}.wav", "captions": c}) + "\n"
                        for i, c in enumerate(TANGO2_PROMPTS)))
    towers, loads, groups = [], {}, []
    real_load, real_init = inference_tango2.load_clap, evaluator.EvaluationHelper.__init__
    real_gen = pipeline.Tango.generate_for_batch

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        clap = real_load(*a, **kw)
        torch.cuda.synchronize()
        loads.setdefault("load_clap_s", []).append(round(time.perf_counter() - t0, 3))
        towers.extend([("clap_text", clap.text.model), ("clap_audio", clap.audio_model)])
        return clap

    def timed_init(self, *a, **kw):
        t0 = time.perf_counter()
        real_init(self, *a, **kw)
        torch.cuda.synchronize()
        loads.setdefault("evaluation_helper_s", []).append(round(time.perf_counter() - t0, 3))
        towers.extend([("cnn14", self.cnn14), ("vggish", self.vggish)])

    def kept_gen(self, *a, **kw):
        groups.append(real_gen(self, *a, **kw))
        return groups[-1]

    out2, out1 = os.path.join(root, "tango2_out"), os.path.join(root, "rerank_out")
    common = ["--model", snap_dir, "--test_file", manifest, "--num_steps", str(STEPS),
              "--clap_ckpt", paths["clap"], "--device", DEVICE]
    inference_tango2.load_clap, evaluator.EvaluationHelper.__init__ = timed_load, timed_init
    pipeline.Tango.generate_for_batch = kept_gen
    cwd = os.getcwd()
    os.chdir(root)
    seconds = {}
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            record = inference_tango2.main(common + [
                "--output_dir", out2, "--batch_size", str(TANGO2_BATCH), "--reference_dir", refs,
                "--cnn14_ckpt", paths["cnn14"], "--vggish_ckpt", paths["vggish"]])
            torch.cuda.synchronize()
            seconds["tango2_cli_s"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
            inference.main(common + ["--output_dir", out1, "--batch_size", str(RERANK_BATCH),
                                     "--num_samples", str(RERANK_SAMPLES)])
            torch.cuda.synchronize()
            seconds["rerank_cli_s"] = round(time.perf_counter() - t0, 3)
    finally:
        inference_tango2.load_clap, evaluator.EvaluationHelper.__init__ = real_load, real_init
        pipeline.Tango.generate_for_batch = real_gen
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    problems = body_problems("tango2_eval", launches, tc, cluster)
    fallback_warned = any("RoBERTa" in str(w.message) for w in caught)

    # the record, against JAX's keys
    metrics = record.get("metrics", {})
    if set(record) != TANGO2_RECORD_KEYS or set(metrics) != METRIC_KEYS:
        problems.append(f"record keys {sorted(record)}, metrics {sorted(metrics)}")
    elif not (math.isfinite(record["clap_score"]) and -1.0 <= record["clap_score"] <= 1.0):
        problems.append(f"clap_score {record['clap_score']}")
    nonfinite = sorted(k for k, v in metrics.items() if not math.isfinite(v))
    if nonfinite != ["is_mean", "is_std"]:
        problems.append(f"non-finite metrics {nonfinite} (only IS is NaN with 4 clips)")
    off_card = [n for n, m in towers if m is None or any(
        t.device.type != "cuda" for t in (*m.parameters(), *m.buffers()))]
    if len(towers) != 6 or off_card:
        problems.append(f"towers {[n for n, _ in towers]}, not on the card: {off_card}")
    if not fallback_warned:
        problems.append("the default CLAP tokenizer did not warn")

    # the re-ranking, recomputed: each output_{i}.wav is its group's argmax
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clap = real_load(paths["clap"], device=DEVICE)
        clap_cpu = real_load(paths["clap"], device="cpu")
    rerank = []
    for i, (prompt, group) in enumerate(zip(TANGO2_PROMPTS, groups[-1])):
        sims = clap.similarity(np.stack([g.astype(np.float32) / 32768.0 for g in group]), prompt)
        pick = int(np.argmax(sims))
        rerank.append({"sims": [round(float(s), 6) for s in sims], "pick": pick})
        if not np.array_equal(read_int16(os.path.join(out1, f"output_{i}.wav")), group[pick]):
            problems.append(f"rerank output_{i}.wav is not its group's CLAP argmax {pick}")

    # the full-width towers on the card against the same modules on the CPU
    waves = np.stack([w.astype(np.float32) / 32768.0 for w in groups[0]])
    clap.audio_batch = clap_cpu.audio_batch = len(waves)
    files = [os.path.join(out2, f"output_{i}.wav") for i in range(len(TANGO2_PROMPTS))]
    card, cpu = (evaluator.EvaluationHelper(16000, device=d, cnn14_ckpt=paths["cnn14"],
                                            vggish_ckpt=paths["vggish"]) for d in (DEVICE, "cpu"))
    card.batch_size = cpu.batch_size = len(files)
    f_card, f_cpu = card.cnn14_features(files), cpu.cnn14_features(files)
    v_card, v_cpu = card.vggish_embeddings(files), cpu.vggish_embeddings(files)
    errors = [
        card_vs_cpu("clap_text", clap.text_embed(TANGO2_PROMPTS),
                    clap_cpu.text_embed(TANGO2_PROMPTS), CARD_CPU_LIMITS["clap_text"]),
        card_vs_cpu("clap_audio", clap.audio_embed(waves), clap_cpu.audio_embed(waves),
                    CARD_CPU_LIMITS["clap_audio"])]
    # HTSAT's trunk alone, on one log-mel: the latent map before pooling and
    # projection, where its TF32 patch convolution shows
    cfg = clap.audio_cfg
    mel = clap_logmel(torch.from_numpy(np.stack(
        [resample_poly(w, 16000, cfg.sample_rate)[:cfg.clip_samples] for w in waves])), cfg)
    with torch.inference_mode():
        lat_card = clap.audio_model.htsat(mel.to(DEVICE))["latent_map"].cpu().numpy()
        lat_cpu = clap_cpu.audio_model.htsat(mel)["latent_map"].numpy()
    errors.append(card_vs_cpu("htsat_latent_map", lat_card, lat_cpu, CARD_CPU_LIMITS["htsat"],
                              float(np.abs(lat_cpu).max())))
    for key in ("2048", "logits"):
        errors.append(card_vs_cpu(f"cnn14_{key}", f_card[key], f_cpu[key],
                                  CARD_CPU_LIMITS["cnn14"], float(np.abs(f_cpu[key]).max())))
    errors.append(card_vs_cpu("vggish", v_card, v_cpu, CARD_CPU_LIMITS["vggish"],
                              float(np.abs(v_cpu).max())))
    problems += [f"{e['what']}: card vs CPU {e['err']:.3g} over its limit {e['limit']}"
                 for e in errors if not e["ok"]]
    log("tango2_eval", phase_s=round(time.perf_counter() - t_phase, 3), **seconds,
        checkpoints_write_s=ckpts["write_s"], checkpoint_bytes=ckpts["bytes"], **loads,
        peak_memory_bytes=peak, clap_score=record.get("clap_score"), metrics=metrics,
        rerank=rerank, card_vs_cpu=errors, fallback_tokenizer_warned=fallback_warned,
        launches=launches, tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    del clap, clap_cpu, card, cpu, towers, groups
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("tango2_eval: " + "; ".join(problems))
    return launches, shapes, tc, cluster

def music_unet_json(C) -> dict:
    """TANGO_UNET's geometry as Mustango's music_diffusion_model_config.json
    names it: the cross-attention blocks `*Music` (two extra streams, beats
    and chords, as wide as the text's)."""
    def music(block):
        return block + "Music" if block.startswith(("CrossAttn", "UNetMid")) else block

    unet = {k: v for k, v in C.TANGO_UNET.to_dict().items()
            if not k.startswith(("quant_", "extra_cond_"))}
    unet["down_block_types"] = [music(b) for b in unet["down_block_types"]]
    unet["up_block_types"] = [music(b) for b in unet["up_block_types"]]
    unet["mid_block_type"] = music(unet["mid_block_type"])
    return {"_class_name": "UNet2DConditionModelMusic", "act_fn": "silu", **unet}


def write_mustango_snapshot(root: str, C, m, beats_model, chords_model) -> dict:
    """Mustango `m`'s weights and the two predictors' in the released layout
    under `root`, through the port's exporters: configs/ (the VAE's geometry
    nested in `ddconfig`), vae/ (the decoder and the weight-normed vocoder),
    ldm/ (`save_ldm_bin`: the music UNet, the T5 encoder, the conditioner),
    beats/ (`export_deberta_beats`) and chords/ (`export_t5_seq2seq`).
    Returns bytes and seconds."""
    from tango_tpu_torch.utils.export import (export_deberta_beats, export_t5_seq2seq,
                                              save_ldm_bin)

    t0 = time.perf_counter()
    for sub in ("configs", "vae", "ldm", "beats", "chords"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    configs = {
        "main_config.json": {"text_encoder_name": "google/flan-t5-large",
                             "scheduler_name": "stabilityai/stable-diffusion-2-1",
                             "unet_model_config_path":
                                 "configs/music_diffusion_model_config.json"},
        "vae_config.json": released_vae_config(C),
        "music_diffusion_model_config.json": music_unet_json(C),
        "stft_config.json": C.TANGO_STFT.to_dict(),
    }
    for name, cfg in configs.items():
        with open(os.path.join(root, "configs", name), "w") as f:
            json.dump(cfg, f, indent=2)
    torch.save(reference_vae_state_dict(m.vae.state_dict(), m.vocoder.state_dict()),
               os.path.join(root, "vae", "pytorch_model_vae.bin"))
    save_ldm_bin(os.path.join(root, "ldm", "pytorch_model_ldm.bin"), m.model.unet.state_dict(),
                 m.t5.state_dict(), m.model.conditioner.state_dict())
    torch.save(export_deberta_beats(beats_model.state_dict()),
               os.path.join(root, "beats", "microsoft-deberta-v3-large.pt"))
    torch.save(export_t5_seq2seq(chords_model.state_dict()),
               os.path.join(root, "chords", "flan-t5-large.bin"))
    seconds = time.perf_counter() - t0
    sizes = {os.path.join(sub, n): os.path.getsize(os.path.join(root, sub, n))
             for sub in sorted(os.listdir(root))
             for n in sorted(os.listdir(os.path.join(root, sub)))}
    return {"write_s": round(seconds, 3), "bytes": sum(sizes.values()),
            "bin_bytes": {n: b for n, b in sizes.items() if not n.endswith(".json")}}


def compare_modules(pairs) -> dict:
    """(name, written module, loaded module, exact) -> per module the tensors,
    elements, elements that differ and the largest difference in bf16 steps
    (of the written value). An exact module must load bit-equal; the others
    (the vocoder: the weight-norm fold) within one bf16 step. Raises."""
    out, problems = {}, []
    for name, a_mod, b_mod, exact in pairs:
        a, b = a_mod.state_dict(), b_mod.state_dict()
        if set(a) != set(b):
            problems.append(f"{name}: keys differ")
            continue
        differ = sum(int((a[k] != b[k]).sum()) for k in a)
        worst = max(((a[k].float() - b[k].float()).abs() / bf16_ulp(a[k])).max().item()
                    for k in a)
        out[name] = {"tensors": len(a), "elements": sum(v.numel() for v in a.values()),
                     "differ": differ, "max_ulps": worst}
        if exact and differ:
            problems.append(f"{name}: {differ} elements differ")
        if worst > 1.0:
            problems.append(f"{name}: {worst} bf16 steps off")
    if problems:
        raise AssertionError(f"loaded snapshot: {'; '.join(problems)} ({out})")
    return out


def first_divergence(card_lps, cpu_lps, num_beams: int, min_length: int, eos: int,
                     card_dtype=None):
    """Replays T5Seq2Seq.generate's candidate ranking on two runs' per-step
    log-probabilities in lockstep (the card's and the CPU's, or the card's
    device loop's and its host loop's), the second's scores summed in f64 as
    the host loop sums them, the first's in `card_dtype` (f64 by default;
    np.float32 for the device loop's). None when every step ranks the same
    top 2*num_beams candidates; else (step, the second run's margin between
    its candidate and the first's at the first rank that differs, scored by
    the second, and the largest difference of those candidates' scores
    between the two at that step)."""
    import numpy as np

    card_dtype = card_dtype or np.float64
    sb = np.full(num_beams, -1e9)
    sb[0] = 0.0
    sa = sb.astype(card_dtype)
    for s, (a, b) in enumerate(zip(card_lps, cpu_lps)):
        a, b = a.astype(card_dtype), b.copy()
        if s + 1 < min_length:
            a[:, eos] = b[:, eos] = -np.inf
        fa, fb = (sa[:, None] + a).reshape(-1), (sb[:, None] + b).reshape(-1)
        ta = np.argsort(-fa, kind="stable")[: 2 * num_beams]
        tb = np.argsort(-fb, kind="stable")[: 2 * num_beams]
        if not np.array_equal(ta, tb):
            r = int(np.nonzero(ta != tb)[0][0])
            idx = np.union1d(ta, tb)
            return s, float(fb[tb[r]] - fb[ta[r]]), float(np.abs(fa[idx] - fb[idx]).max())
        keep = [int(i) for i in ta if i % a.shape[1] != eos][:num_beams]
        if len(keep) < num_beams:
            break
        sa, sb = fa[keep], fb[keep]
    return None


def predictors_card_vs_cpu(pred, beats_io: list, chords_io: list, card_lps: list,
                           card_tokens) -> dict:
    """The predictors of the `mustango` path on the card against the same
    modules on the CPU, both f32 (matmuls without TF32): DeBERTa's logits
    and intervals on the path's tokens, the T5 decoder's first-step
    log-probabilities, and the host beam search's tokens on the card
    (`card_tokens`, `card_lps` its log-probabilities) against the CPU's
    (`first_divergence` explains a difference by a near-tie or fails).
    Raises past PREDICTOR_LIMITS."""
    import numpy as np

    from tango_tpu_torch.models.deberta import DebertaV2ForBeats
    from tango_tpu_torch.models.t5 import T5Seq2Seq

    def on_cpu(make, module):
        with torch.device("meta"):
            m = make()
        m = m.to_empty(device="cpu")
        m.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
        return m.eval().requires_grad_(False)

    t0 = time.perf_counter()
    out = {}
    bm = on_cpu(lambda: DebertaV2ForBeats(pred.beats_model.cfg), pred.beats_model)
    (ids, mask), (logits, values) = beats_io[0]
    with torch.inference_mode():
        c_logits, c_values = bm(ids.cpu(), mask.cpu())
    n = int(mask[0].sum())
    for name, card, cpu in (("deberta_logits", logits, c_logits),
                            ("deberta_values", values, c_values)):
        card, cpu = card[0, :n].float().cpu().numpy(), cpu[0, :n].float().numpy()
        out[name] = card_vs_cpu(name, card, cpu, PREDICTOR_LIMITS["deberta"],
                                float(np.abs(cpu).max()))
    del bm
    cm = on_cpu(lambda: T5Seq2Seq(pred.chords_model.cfg), pred.chords_model)
    (c_ids, c_mask, kw), _ = chords_io[0]
    cpu_lps, step = [], cm.step

    def recording_step(*a, **k):
        lp = step(*a, **k)
        cpu_lps.append(lp.double().numpy())
        return lp

    cm.step = recording_step
    cpu_tokens = cm.generate(c_ids.cpu(), c_mask.cpu(), device_loop=False, **kw)
    out["t5_first_step"] = card_vs_cpu("t5_first_step", card_lps[0], cpu_lps[0],
                                       PREDICTOR_LIMITS["t5_first_step"],
                                       float(np.abs(cpu_lps[0]).max()))
    problems = [f"{k}: {v['err']} of the largest magnitude, over {v['limit']}"
                for k, v in out.items() if not v["ok"]]
    same = np.array_equal(card_tokens, cpu_tokens)
    beams = {"tokens_equal": bool(same), "card_len": len(card_tokens),
             "cpu_len": len(cpu_tokens), "steps": len(card_lps)}
    if not same:
        div = first_divergence(card_lps, cpu_lps, kw["num_beams"], kw["min_length"], 1)
        beams["divergence"] = div
        if div is None or not div[1] <= 2 * div[2]:
            problems.append(f"beam tokens differ, not at a near-tie: {div}")
    out["beams"] = beams
    out["seconds"] = round(time.perf_counter() - t0, 3)
    log("mustango_predictors", **out, problems=problems)
    if problems:
        raise AssertionError("mustango predictors: " + "; ".join(problems))
    return out


def beam_loops_on_card(model, chords_io: list, counted_stats: dict) -> tuple:
    """The chord predictor's three loops on the card, uncounted, on the
    counted path's prompt (`counted_stats` its search's `beam_stats`, which
    must be the graphed loop's): the graphed device loop again (warm: its tokens
    must equal the counted run's), the same device loop eager (timed, then
    once more with its log-probabilities recorded) and the host loop with
    its log-probabilities recorded. The device loop's tokens must equal the
    host loop's, or the eager loop's equal them and `first_divergence` find
    a near-tie at the first step that ranks apart (f32 scores against f64).
    -> (the log line, the host loop's log-probabilities and tokens)."""
    import numpy as np

    (ids, mask, kw), graph_tokens = chords_io[0]
    out = {"counted": counted_stats}

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = call()
        torch.cuda.synchronize()
        return toks, round(time.perf_counter() - t0, 4), dict(model.beam_stats)

    warm, out["graph_warm_s"], out["graph_warm"] = timed(lambda: model.generate(ids, mask, **kw))
    with torch.inference_mode():
        pre = model.precompute(model.encode(ids, mask), mask, kw["max_length"])
    full = dict(kw, length_penalty=1.0, eos_token_id=1, pad_token_id=0, decoder_start_token_id=0)
    eager, out["eager_s"], out["eager"] = timed(
        lambda: model.device_beam_search(*pre, graph=False, **full))
    eager_lps, host_lps, static_step, step = [], [], model.static_step, model.step

    def recording(fn, into):
        def call(*a, **k):
            lp = fn(*a, **k)
            into.append(lp.double().cpu().numpy())
            return lp
        return call

    model.static_step = recording(static_step, eager_lps)
    try:
        eager_rec = model.device_beam_search(*pre, graph=False, **full)
    finally:
        del model.static_step
    model.step = recording(step, host_lps)
    try:
        host, out["host_s"], out["host"] = timed(
            lambda: model.generate(ids, mask, device_loop=False, **kw))
    finally:
        del model.step
    problems = []
    if not (counted_stats["loop"] == "device" and counted_stats["graph"]):
        problems.append(f"the counted chord search ran {counted_stats}, not the graphed loop")
    if not np.array_equal(warm, graph_tokens):
        problems.append("a second graphed search gave other tokens")
    if not np.array_equal(eager_rec, eager):
        problems.append("two eager device searches gave other tokens")
    out["device_vs_host_equal"] = same = bool(np.array_equal(graph_tokens, host))
    out["graph_vs_eager_equal"] = bool(np.array_equal(graph_tokens, eager))
    out["lens"] = {"device": len(graph_tokens), "host": len(host)}
    if not same:
        # the eager loop's steps stand for the graph's only where they agree
        div = first_divergence(eager_lps, host_lps, kw["num_beams"], kw["min_length"], 1,
                               card_dtype=np.float32)
        out["divergence"] = div
        if not out["graph_vs_eager_equal"] or div is None or not div[1] <= 2 * div[2]:
            problems.append(f"device and host loop tokens differ, not at a near-tie: {div}")
    out["problems"] = problems
    log("mustango_beam_loops", **out)
    if problems:
        raise AssertionError("mustango beam loops: " + "; ".join(problems))
    return out, host_lps, host


def mustango_phase(C, ops, tango, counted, instrument, expect_len: int, root: str) -> tuple:
    """Phase `mustango`: the full-width Mustango (TANGO_UNET's geometry with
    the `*Music` blocks, FLAN-T5-Large, TANGO_VAE, TANGO_HIFIGAN, a 1024-wide
    music conditioner, DeBERTa-v3-large and an untied FLAN-T5-large seq2seq)
    from seeded random weights, written in the released layout under `root`,
    loaded by Mustango(dir) in bf16 (weights equal to the written ones, the
    three tokenizer fallbacks warned), then counted as path `mustango`:
    generate(MUSTANGO_PROMPT) with both predictors, generate_for_batch of
    MUSTANGO_PROMPTS with explicit features, and generate of the first
    prompt with the same features, whose latents the batch's row 0 must
    match; the chord search runs its default, the graphed device loop, whose
    steps and host syncs are logged. Checks the launch bodies, 3x Tango's
    attn_fwd an evaluation, the chord search's loops against each other
    (`beam_loops_on_card`) and the predictors card vs CPU; then, uncounted,
    export-mustango reloaded bit-equal and serve.main --music once. Deletes
    `root`. Returns counted's (launches, shapes)."""
    import dataclasses
    import wave

    import numpy as np

    from tango_tpu_torch import convert_cli, serve
    from tango_tpu_torch.models.deberta import DebertaV2ForBeats
    from tango_tpu_torch.models.t5 import T5Attention, T5Seq2Seq
    from tango_tpu_torch.pipeline_music import Mustango
    from tango_tpu_torch.utils.convert import load_torch_bin
    from tango_tpu_torch.utils.init import init_random_

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    snap = os.path.join(root, "snapshot")
    music_cfg = C.UNetConfig.from_dict(music_unet_json(C))
    m = Mustango.from_components(unet_config=music_cfg, vae_config=C.TANGO_VAE,
                                 t5_config=C.FLAN_T5_LARGE, hifigan_config=C.TANGO_HIFIGAN,
                                 device=DEVICE, init_seed=7)
    gen = torch.Generator(device=DEVICE).manual_seed(8)

    def random_f32(make):
        with torch.device("meta"):
            mod = make()
        return init_random_(mod.to_empty(device=DEVICE), gen).eval().requires_grad_(False)

    beats_model = random_f32(lambda: DebertaV2ForBeats(C.DEBERTA_V3_LARGE))
    chords_cfg = dataclasses.replace(C.FLAN_T5_LARGE, tie_word_embeddings=False)
    chords_model = random_f32(lambda: T5Seq2Seq(chords_cfg))
    # T5 folds attention's 1 / sqrt(d_kv) into q's initial scale (HF's
    # T5PreTrainedModel._init_weights: q (d_model * d_kv)^-0.5, the rest as
    # init_random_); at 1 / fan_in the logits are ~8 wide, the softmax nearly
    # one-hot, and f32 rounding grows through the layers
    with torch.no_grad():
        for mod in chords_model.modules():
            if isinstance(mod, T5Attention):
                mod.q.weight.mul_(chords_cfg.d_kv**-0.5)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in mod.parameters()) for name, mod in (
        ("unet", m.model.unet), ("t5", m.t5), ("conditioner", m.model.conditioner),
        ("vae", m.vae), ("vocoder", m.vocoder), ("deberta", beats_model),
        ("t5_seq2seq", chords_model))}
    # f32 on disk: the snapshot, and export-mustango's copy of all but vae/
    need = 4 * (2 * sum(counts.values()) - counts["vae"] - counts["vocoder"]) + 2e9
    free = shutil.disk_usage(os.path.dirname(root)).free
    if free < need:
        raise AssertionError(f"mustango: {free} bytes free under {os.path.dirname(root)}, "
                             f"the snapshot and its export need about {int(need)}")
    written = write_mustango_snapshot(snap, C, m, beats_model, chords_model)
    log("mustango_build", seconds=round(time.perf_counter() - t_phase, 3), params=counts,
        disk_free_bytes=free, disk_needed_bytes=int(need), **written)

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ms = Mustango(snap, device=DEVICE)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    fallbacks = sorted(str(w.message).split(":")[0] for w in caught
                       if "word-hash tokenizer" in str(w.message))
    if len(fallbacks) != 3 or ms.predictor is None:
        raise AssertionError(f"mustango: fallback warnings {fallbacks} (3 expected), "
                             f"predictor {ms.predictor}")
    params = compare_modules([
        ("unet", m.model.unet, ms.model.unet, True), ("t5", m.t5, ms.t5, True),
        ("conditioner", m.model.conditioner, ms.model.conditioner, True),
        ("vae", m.vae, ms.vae, True), ("vocoder", m.vocoder, ms.vocoder, False),
        ("deberta", beats_model, ms.predictor.beats_model, True),
        ("t5_seq2seq", chords_model, ms.predictor.chords_model, True)])
    del m, beats_model, chords_model
    torch.cuda.empty_cache()

    # one UNet evaluation of each pipeline: attn_fwd launches
    unet = ms.model.unet
    lat = torch.randn(2, ms.model.latent_t_size, ms.model.latent_f_size, unet.cfg.in_channels,
                      device=DEVICE)
    ctx = [torch.randn(2, n, unet.cfg.cross_attention_dim, device=DEVICE, dtype=ms.dtype)
           for n in (ms.max_text_length, ms.model.beat_len, ms.model.chord_len)]
    masks = [torch.ones(c.shape[:2], dtype=torch.long, device=DEVICE) for c in ctx]
    steps = torch.tensor([999, 999], device=DEVICE)
    per_eval = {}
    for name, net, c, mask in (("tango", tango.model.unet, ctx[0], masks[0]),
                               ("mustango", unet, ctx, masks)):
        ops.reset_counters()
        with torch.inference_mode():
            net(lat, steps, c, mask)
        torch.cuda.synchronize()
        per_eval[name] = {n: fn.launches for n, fn in ops.KERNELS.items() if fn.launches}

    # the counted path; the predictors' inputs, outputs and log-probabilities,
    # the features and every decoded latent recorded
    pred = ms.predictor
    beats_io, chords_io, latents, rec = [], [], [], {}
    hook = pred.beats_model.register_forward_hook(
        lambda mod, args, out: beats_io.append((args, out)))
    real_generate, real_pred = pred.chords_model.generate, pred.generate

    def recording_generate(ids, mask, **kw):
        toks = real_generate(ids, mask, **kw)
        chords_io.append(((ids, mask, kw), toks))
        rec["beam"] = dict(pred.chords_model.beam_stats)
        return toks

    def recording_pred(prompt):
        s0 = time.perf_counter()
        rec["features"] = pred_out = real_pred(prompt)
        torch.cuda.synchronize()
        rec["predictors_s"] = time.perf_counter() - s0
        return pred_out

    pred.chords_model.generate = recording_generate
    pred.generate = recording_pred
    remove = instrument(ms)
    checked_decode = ms.decode

    def recording_decode(lat_):
        latents.append(lat_.float().clone())
        return checked_decode(lat_)

    ms.decode = recording_decode
    beats, chords, times = [MUSTANGO_BEATS], MUSTANGO_CHORDS[0], MUSTANGO_CHORDS[1]
    n = len(MUSTANGO_PROMPTS)
    calls = (
        ("generate", lambda: [ms.generate(MUSTANGO_PROMPTS[0], steps=STEPS, seed=0)]),
        ("generate_for_batch", lambda: ms.generate_for_batch(
            MUSTANGO_PROMPTS, steps=STEPS, batch_size=MUSTANGO_BATCH, seed=0, beats=[beats] * n,
            chords=[chords] * n, chords_times=[times] * n)),
        ("generate_features", lambda: [ms.generate(
            MUSTANGO_PROMPTS[0], steps=STEPS, seed=0, beats=beats, chords=chords,
            chords_times=times)]))

    def drive():
        outs, seconds = [], {}
        for name, call in calls:
            s0 = time.perf_counter()
            outs += call()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - s0
        if len(outs) != n + 2:
            raise AssertionError(f"{len(outs) - 2} waveforms for {n} prompts")
        batch0, single = latents[1][0], latents[2][0]
        rec["row0"] = {"latents_max_abs_diff": (batch0 - single).abs().max().item(),
                       "latents_rel_l2": ((batch0 - single).norm() / single.norm()).item(),
                       "wav_max_int16_diff": int(np.abs(outs[1].astype(np.int32)
                                                        - outs[-1].astype(np.int32)).max())}
        return outs, seconds

    def extra(launches):
        pb = rec["features"][0]
        return dict(cold_start_s=round(cold_s, 3), dtype=str(ms.dtype), params=params,
                    fallback_tokenizers=fallbacks, per_eval=per_eval,
                    attn_fwd_per_eval=launches["attn_fwd"] / (len(calls) * STEPS),
                    predictors_s=round(rec["predictors_s"], 3),
                    beam_loop=rec["beam"]["loop"], beam_graph=rec["beam"]["graph"],
                    beam_steps=rec["beam"]["steps"], beam_syncs=rec["beam"]["syncs"],
                    predicted_beats=len(pb[0][0]) if pb and pb[0] else 0,
                    predicted_chords=rec["features"][1], row0=rec["row0"])

    launches, shapes = counted("mustango", drive, expect_len, extra=extra)
    ms.decode = checked_decode
    remove()
    hook.remove()
    del pred.chords_model.generate
    pred.generate = real_pred
    problems = []
    tango_attn, music_attn = (per_eval[k].get("attn_fwd", 0) for k in ("tango", "mustango"))
    evals = len(calls) * STEPS
    if music_attn != 3 * tango_attn or launches["attn_fwd"] != music_attn * evals:
        problems.append(f"attn_fwd: {music_attn} an evaluation against Tango's {tango_attn} "
                        f"(3x expected), {launches['attn_fwd']} on the path for {evals} "
                        "evaluations")
    if not rec["row0"]["latents_rel_l2"] <= MUSTANGO_ROW0_REL_L2:
        problems.append(f"batch row 0 vs generate: {rec['row0']}, relative L2 over "
                        f"{MUSTANGO_ROW0_REL_L2}")
    if problems:
        raise AssertionError("mustango: " + "; ".join(problems))
    _, card_lps, card_tokens = beam_loops_on_card(pred.chords_model, chords_io, rec["beam"])
    predictors_card_vs_cpu(pred, beats_io, chords_io, card_lps, card_tokens)
    del ms, pred, unet, beats_io, chords_io, card_lps, latents, remove, calls
    torch.cuda.empty_cache()

    # uncounted: export-mustango of the snapshot's own UNet, reloaded
    # bit-equal, then the serving CLI once on the snapshot
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "export")
    convert_cli.main(["export-mustango", snap, "-", out_dir])
    export_s = time.perf_counter() - t0
    a = load_torch_bin(os.path.join(snap, "ldm", "pytorch_model_ldm.bin"))
    b = load_torch_bin(os.path.join(out_dir, "ldm", "pytorch_model_ldm.bin"))
    same = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    copied = all(os.path.getsize(os.path.join(snap, sub, n)) ==
                 os.path.getsize(os.path.join(out_dir, sub, n))
                 for sub in ("configs", "vae", "beats", "chords")
                 for n in os.listdir(os.path.join(snap, sub)))
    n_keys = len(a)
    del a, b
    shutil.rmtree(out_dir)
    wav_path = os.path.join(root, "music.wav")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fallback tokenizers', checked above
        serve.main(["--music", "--model", snap, "--prompt", MUSTANGO_PROMPTS[0], "--steps", "2",
                    "--seed", "0", "--output", wav_path, "--device", DEVICE])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    with wave.open(wav_path) as w:
        wav_format = (w.getframerate(), w.getsampwidth(), w.getnchannels())
    pcm = read_int16(wav_path)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    problems = []
    if not (same and copied):
        problems.append(f"export-mustango: ldm bin bit-equal {same}, copies {copied}")
    if wav_format != (16000, 2, 1):
        problems.append(f"serve --music wrote a WAV of (rate, bytes, channels) {wav_format}")
    if pcm.shape != (expect_len,) or int(np.abs(pcm.astype(np.int32)).max()) == 0:
        problems.append(f"serve --music wrote {pcm.shape} samples, peak "
                        f"{int(np.abs(pcm.astype(np.int32)).max()) if pcm.size else 0}")
    log("mustango_cli", export_s=round(export_s, 3), ldm_keys=n_keys, ldm_bit_equal=same,
        serve_music_s=round(cli_s, 3), serve_wav_samples=int(pcm.size),
        phase_s=round(time.perf_counter() - t_phase, 3), problems=problems)
    if problems:
        raise AssertionError("mustango: " + "; ".join(problems))
    return launches, shapes


FILM_NAMES = (
    (r"^input_(\d+)_res\.", r"input_blocks.\1.0."),
    (r"^input_(\d+)_attn\.", r"input_blocks.\1.1."),
    (r"^input_(\d+)_down\.conv\.", r"input_blocks.\1.0.op."),
    (r"^middle_res1\.", "middle_block.0."),
    (r"^middle_attn\.", "middle_block.1."),
    (r"^middle_res2\.", "middle_block.2."),
    (r"^output_(\d+)_res\.", r"output_blocks.\1.0."),
    (r"^output_(\d+)_attn\.", r"output_blocks.\1.1."),
    (r"^input_conv\.", "input_blocks.0.0."),
    (r"^time_embed_(\d)\.", r"time_embed.\1."),
    (r"^out_norm\.", "out.0."),
    (r"^out_conv\.", "out.2."),
)
# inside a block: the res block's and the transformer's layers
FILM_LAYER_NAMES = (
    (r"\.in_norm\.", ".in_layers.0."), (r"\.in_conv\.", ".in_layers.2."),
    (r"\.emb_proj\.", ".emb_layers.1."), (r"\.out_norm\.", ".out_layers.0."),
    (r"\.out_conv\.", ".out_layers.3."), (r"\.skip\.", ".skip_connection."),
    (r"\.(norm[123]|attn[12]|ff)\.", r".transformer_blocks.0.\1."),
    (r"\.to_out_0\.", ".to_out.0."), (r"\.ff\.net_0_proj\.", ".ff.net.0.proj."),
    (r"\.ff\.net_2\.", ".ff.net.2."))


def reference_film_unet_state_dict(unet) -> dict:
    """FiLM UNet `unet`'s weights under the reference's openai UNetModel
    names, f32 on the host: `convert_film_unet` run backwards (each
    self-attention's to_qkv split into to_q, to_k, to_v; an upsample after
    an output block's transformer is its layer 2, else 1). Builds the
    smoke's monolithic checkpoint, nothing else."""
    out = {}
    for k, v in unet.state_dict().items():
        v = v.detach().to("cpu", torch.float32)
        up = re.match(r"^output_(\d+)_up\.conv\.", k)
        if up:
            layer = 2 if hasattr(unet, f"output_{up[1]}_attn") else 1
            k = f"output_blocks.{up[1]}.{layer}.conv." + k[up.end():]
        else:
            for rx, rep in FILM_NAMES:
                k, n = re.subn(rx, rep, k)
                if n:
                    break
        for rx, rep in FILM_LAYER_NAMES:
            k = re.sub(rx, rep, k)
        if k.endswith(".to_qkv.weight"):
            for name, part in zip("qkv", v.chunk(3)):
                out[k[: -len("qkv.weight")] + f"{name}.weight"] = part.clone()
        else:
            out[k] = v
    return out


def write_audioldm_checkpoint(path: str, C) -> tuple:
    """A full-width monolithic audioldm-s-full checkpoint of seeded random f32
    weights at `path`, in the released layout ({"state_dict": ...}): the FiLM
    UNet (AUDIOLDM_S_UNET) under `model.diffusion_model.`, TANGO_VAE with its
    encoder and the weight-normed TANGO_HIFIGAN vocoder under
    `first_stage_model.` (`reference_vae_state_dict`), RoBERTa-base,
    HTSAT-tiny and both projections under `cond_stage_model.model.`
    (LAION-CLAP's names), and `scale_factor`. Every part converts back
    through the port's converters bit-equal, the vocoder within f32 rounding
    (the weight-norm fold); checked. Returns (the written modules by name,
    bytes and seconds)."""
    from tango_tpu_torch.models.audioldm_unet import AUDIOLDM_S_UNET, FilmUNet, \
        convert_film_unet
    from tango_tpu_torch.models.clap import ROBERTA_BASE, ClapTextEncoder, convert_clap_text
    from tango_tpu_torch.models.hifigan import HiFiGANGenerator
    from tango_tpu_torch.models.htsat import HTSAT_TINY, ClapAudioEncoder, convert_clap_audio
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.utils import convert as conv
    from tango_tpu_torch.utils.init import init_random_

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(21)

    def made(make):
        with torch.device("meta"):
            m = make()
        return init_random_(m.to_empty(device=DEVICE), gen).eval().requires_grad_(False)

    mods = {"unet": made(lambda: FilmUNet(AUDIOLDM_S_UNET)),
            "vae": made(lambda: AutoencoderKL(C.TANGO_VAE, with_encoder=True)),
            "vocoder": made(lambda: HiFiGANGenerator(C.TANGO_HIFIGAN)),
            "clap_text": made(lambda: ClapTextEncoder(ROBERTA_BASE)),
            "clap_audio": made(lambda: ClapAudioEncoder(HTSAT_TINY))}
    pre = "cond_stage_model.model."
    unet_ref = reference_film_unet_state_dict(mods["unet"])
    vae_ref = reference_vae_state_dict(mods["vae"].state_dict(), mods["vocoder"].state_dict())
    clap_ref = {**renamed(mods["clap_text"].state_dict(), CLAP_TEXT_NAMES),
                **renamed(mods["clap_audio"].state_dict(), CLAP_AUDIO_NAMES)}
    sd = {**{"model.diffusion_model." + k: v for k, v in unet_ref.items()},
          **{"first_stage_model." + k: v for k, v in vae_ref.items()},
          **{pre + k: v for k, v in clap_ref.items()},
          "scale_factor": torch.tensor(AUDIOLDM_SCALE)}
    vocoder_ref = {k[len("vocoder."):]: v for k, v in vae_ref.items()
                   if k.startswith("vocoder.")}
    back = {"unet": convert_film_unet(unet_ref, AUDIOLDM_S_UNET),
            "vae": conv.convert_vae(vae_ref, with_encoder=True),
            "vocoder": conv.convert_hifigan(vocoder_ref),
            "clap_text": convert_clap_text(clap_ref),
            "clap_audio": convert_clap_audio(clap_ref, HTSAT_TINY)}
    problems = []
    for name, b in back.items():
        a = {k: v.cpu() for k, v in mods[name].state_dict().items()}
        if set(a) != set(b):
            problems.append(f"{name}: keys differ")
        elif name == "vocoder":
            worst = max(((a[k] - b[k]).abs() / a[k].abs().amax().clamp(min=1e-30)).max().item()
                        for k in a)
            if worst > 1e-6:
                problems.append(f"vocoder: {worst} relative off after the weight-norm fold")
        elif any(not torch.equal(a[k], b[k]) for k in a):
            problems.append(f"{name}: tensors differ")
    if problems:
        raise AssertionError(f"audioldm checkpoint does not convert back: {problems}")
    del back, unet_ref, vae_ref, clap_ref, vocoder_ref
    torch.save({"state_dict": sd}, path)
    del sd
    counts = {n: sum(p.numel() for p in m.parameters()) for n, m in mods.items()}
    return mods, {"write_s": round(time.perf_counter() - t0, 3),
                  "bytes": os.path.getsize(path), "params": counts}


def audioldm_phase(C, ops, counted, root: str) -> tuple:
    """Phase `audioldm`: the full-width AudioLDM-S written as a monolithic
    checkpoint of seeded random weights under `root` (write_audioldm_checkpoint),
    loaded by `build_model` in f32 with the port's RoBERTa word-hash tokenizer
    (the native CLAP, not the stub), every weight held to the written one;
    one UNet evaluation's launches (AUDIOLDM_PER_EVAL) and, uncounted, the
    device time of one at CFG batch 6 by kernel, with attn_fwd's tensor-core
    body and with its CUDA-core one (attn_fwd_core); then path `audioldm`,
    counted: text_to_audio at AUDIOLDM_SECONDS, STEPS DDIM steps (eta 1.0),
    AUDIOLDM_CANDIDATES candidates (CFG batch 6), AUDIOLDM_GUIDANCE, whose
    output must be the candidate of the largest CLAP similarity;
    style_transfer of a written 10 s WAV at AUDIOLDM_STRENGTH; and
    super_resolution_and_inpainting, whose final latents must equal the
    source's outside the mask. Every attention launch on the tensor-core body
    (head dim 32), AUDIOLDM_PER_EVAL["attn_fwd"] an evaluation, every
    GroupNorm on its cluster body. Then, uncounted: one FiLM UNet evaluation
    and one DDIM step (eta 0) on the card against the CPU in f32
    (AUDIOLDM_CARD_CPU_LIMIT); `python -m tango_tpu_torch.audioldm` once in
    a subprocess on the checkpoint. Deletes `root`. Returns counted's
    (launches, shapes)."""
    import numpy as np

    from tango_tpu_torch.audio.wav import write_wav
    from tango_tpu_torch.audioldm import pipeline as pl
    from tango_tpu_torch.models.audioldm_unet import FilmUNet
    from tango_tpu_torch.models.layers import frozen
    from tango_tpu_torch.tokenizer import roberta_word_hash

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ckpt = os.path.join(root, "audioldm-s-full.ckpt")
    need = 3e9
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"audioldm: {free} bytes free under {root}, the checkpoint "
                             f"needs about {int(need)}")
    written, info = write_audioldm_checkpoint(ckpt, C)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = pl.build_model(ckpt, tokenizer=roberta_word_hash(), device=DEVICE)
    # the modules are built at first use: the load includes them
    unet, _, _ = pipe.unet, pipe.vae, pipe.vocoder
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    from tango_tpu_torch.models.clap import Clap

    if not isinstance(pipe.conditioner, Clap):
        raise AssertionError(f"audioldm: the conditioner is {type(pipe.conditioner).__name__}, "
                             "not the native CLAP")
    params = compare_modules([
        ("unet", written["unet"], unet, True), ("vae", written["vae"], pipe.vae, True),
        ("vocoder", written["vocoder"], pipe.vocoder, False),
        ("clap_text", written["clap_text"], pipe.conditioner.text.model, True),
        ("clap_audio", written["clap_audio"], pipe.conditioner.audio_model, True)])
    del written
    torch.cuda.empty_cache()
    log("audioldm_build", **info, load_s=round(load_s, 3),
        scale_factor=pipe.vae_config.scale_factor, params_checked=params, dtype=str(pipe.dtype))

    n_cand = AUDIOLDM_CANDIDATES
    frames = pl.duration_to_latent_t_size(AUDIOLDM_SECONDS)
    film = torch.from_numpy(np.repeat(pipe.conditioner.text_embed([AUDIOLDM_PROMPT]),
                                      2 * n_cand, axis=0)).to(DEVICE)
    lat = torch.randn(2 * n_cand, frames, pipe.latent_f_size, 8, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(5))
    steps = torch.full((2 * n_cand,), 901, device=DEVICE)
    ops.reset_counters()
    with torch.inference_mode():
        unet(lat, steps, film)
    torch.cuda.synchronize()
    per_eval = {n: fn.launches for n, fn in ops.KERNELS.items() if fn.launches}
    eval_shapes = sorted(ops.KERNELS["attn_fwd"].shapes, key=str)
    if any(per_eval.get(n, 0) != v for n, v in AUDIOLDM_PER_EVAL.items()) or \
            per_eval.get("gn_stats", 0):
        raise AssertionError(f"audioldm: one UNet evaluation launched {per_eval}, expected "
                             f"{AUDIOLDM_PER_EVAL} and no two-stage GroupNorm")
    # the device time of one evaluation by kernel, and of the same evaluation
    # with every attn_fwd call on the CUDA-core body (the attention dispatch
    # reads attn_fwd from its module at each call)
    import tango_tpu_torch.ops.attention as attn_ops

    with torch.inference_mode():
        by_kernel = {"tensor_core": device_ms(lambda: unet(lat, steps, film), 3)}
        attn_ops.attn_fwd = attn_fwd_core
        try:
            by_kernel["cuda_core"] = device_ms(lambda: unet(lat, steps, film), 3)
        finally:
            attn_ops.attn_fwd = ops.KERNELS["attn_fwd"]
    eval_ms = {body: {"device_ms": sum(t.values()),
                      "attn_fwd_ms": sum(v for k, v in t.items() if "attn" in k)}
               for body, t in by_kernel.items()}
    for row in eval_ms.values():
        row["attn_fwd_share"] = row["attn_fwd_ms"] / row["device_ms"]

    # the source clip of style transfer and inpainting: 10 s of partials
    src = os.path.join(root, "source.wav")
    t = np.arange(int(AUDIOLDM_SECONDS * 16000)) / 16000.0
    write_wav(src, (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
                    * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t))).astype(np.float32))

    rec = {"evals": 0, "decoded": [], "z0": [], "sims": [], "sample_s": 0.0, "steps": 0}
    hook = unet.register_forward_pre_hook(lambda *a: rec.__setitem__("evals", rec["evals"] + 1))
    decode, encode, sample = pipe.decode, pipe.encode_first_stage, pipe.sample_latents
    similarity = pipe.conditioner.similarity

    def recording_decode(latents):
        rec["decoded"].append((latents.float().clone(), decode(latents)))
        return rec["decoded"][-1][1]

    def recording_encode(*a, **k):
        rec["z0"].append(encode(*a, **k))
        return rec["z0"][-1]

    def timed_sample(*a, **k):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = sample(*a, **k)
        torch.cuda.synchronize()
        rec["sample_s"] += time.perf_counter() - s0
        rec["steps"] += k["ddim_steps"]
        return out

    def recording_similarity(wavs, prompt):
        rec["sims"].append(np.asarray(similarity(wavs, prompt)))
        return rec["sims"][-1]

    pipe.decode, pipe.encode_first_stage, pipe.sample_latents = (recording_decode,
                                                                 recording_encode, timed_sample)
    pipe.conditioner.similarity = recording_similarity
    checks = {}

    def drive():
        seconds = {}
        s0 = time.perf_counter()
        gen = pl.text_to_audio(pipe, AUDIOLDM_PROMPT, seed=0, ddim_steps=STEPS,
                               duration=AUDIOLDM_SECONDS, batchsize=1,
                               guidance_scale=AUDIOLDM_GUIDANCE, n_candidate_gen_per_text=n_cand)
        torch.cuda.synchronize()
        seconds["text_to_audio"] = time.perf_counter() - s0
        checks["gen_shape"] = list(gen.shape)
        lat, wavs = rec["decoded"][0]
        best = int(np.argmax(rec["sims"][0]))
        checks["rerank"] = {"sims": rec["sims"][0].tolist(), "picked": best,
                            "output_is_picked": bool(np.array_equal(gen[0], wavs[best]))}
        checks["latents_max_abs"] = lat.abs().max().item()
        checks["ms_per_ddim_step_cfg_batch_6"] = 1e3 * rec["sample_s"] / rec["steps"]
        checks["gen_evals"] = rec["evals"]
        s0 = time.perf_counter()
        st = pl.style_transfer(pipe, AUDIOLDM_PROMPT, src, AUDIOLDM_STRENGTH, seed=0,
                               duration=AUDIOLDM_SECONDS, guidance_scale=AUDIOLDM_GUIDANCE,
                               ddim_steps=STEPS)
        torch.cuda.synchronize()
        seconds["style_transfer"] = time.perf_counter() - s0
        s0 = time.perf_counter()
        inp = pl.super_resolution_and_inpainting(pipe, AUDIOLDM_PROMPT, src, seed=0,
                                                 ddim_steps=STEPS, duration=AUDIOLDM_SECONDS,
                                                 guidance_scale=AUDIOLDM_GUIDANCE)
        torch.cuda.synchronize()
        seconds["inpainting"] = time.perf_counter() - s0
        lat_in, z0 = rec["decoded"][-1][0], rec["z0"][-1]
        mask = torch.from_numpy(pl.inpainting_mask(z0.shape[1], z0.shape[2], (0.10, 0.15),
                                                   (1.0, 1.0)) == 0).to(DEVICE).expand_as(z0)
        checks["inpaint_kept_max_abs_diff"] = (lat_in[mask] - z0[mask]).abs().max().item()
        checks["inpaint_kept_share"] = mask.float().mean().item()
        checks["all_latents_finite"] = all(bool(torch.isfinite(x).all())
                                           for x, _ in rec["decoded"])
        return [gen[0], st[0], inp[0]], seconds

    wav_len = frames * 4 * 160 + 32
    lens = [wav_len, (frames - 3) * 4 * 160 + 32, wav_len]

    def extra(launches):
        return dict(load_s=round(load_s, 3), per_eval=per_eval,
                    device_ms_per_eval_cfg_batch_6=eval_ms,
                    attn_fwd_shapes_per_eval=[list(map(list, s)) for s in eval_shapes],
                    evals=rec["evals"], attn_fwd_per_eval=launches["attn_fwd"] / rec["evals"],
                    **checks)

    try:
        launches, shapes = counted("audioldm", drive, lens, extra=extra)
    finally:
        hook.remove()
        pipe.decode, pipe.encode_first_stage, pipe.sample_latents = decode, encode, sample
        pipe.conditioner.similarity = similarity
    problems = []
    if launches["attn_fwd"] != AUDIOLDM_PER_EVAL["attn_fwd"] * rec["evals"]:
        problems.append(f"attn_fwd: {launches['attn_fwd']} launches for {rec['evals']} UNet "
                        f"evaluations, {AUDIOLDM_PER_EVAL['attn_fwd']} an evaluation expected")
    if any(q[2] != 32 for q, _ in shapes["attn_fwd"]):
        problems.append(f"attn_fwd shapes not at head dim 32: {sorted(shapes['attn_fwd'])}")
    if checks["gen_shape"] != [1, wav_len] or not checks["rerank"]["output_is_picked"]:
        problems.append(f"text_to_audio: shape {checks['gen_shape']}, "
                        f"re-ranking {checks['rerank']}")
    if checks["inpaint_kept_max_abs_diff"] != 0.0:
        problems.append(f"inpainting: latents outside the mask differ from the source's by "
                        f"{checks['inpaint_kept_max_abs_diff']}")
    if not checks["all_latents_finite"]:
        problems.append("non-finite latents")
    if problems:
        raise AssertionError("audioldm: " + "; ".join(problems))

    # uncounted: one UNet evaluation (batch 1) and one DDIM step (eta 0) on
    # the card against the CPU, f32
    cpu_unet = frozen(lambda: FilmUNet(pipe.unet_config), pipe.unet_params, "cpu")
    x, f, tt = lat[:1].float().cpu(), film[:1].float().cpu(), torch.tensor([901])
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_cpu = cpu_unet(x, tt, f)
        step_cpu, _ = pipe.scheduler.step(out_cpu, 901, x, None, STEPS, eta=0.0)
        out_card = unet(x.to(DEVICE), tt.to(DEVICE), f.to(DEVICE)).float()
        step_card, _ = pipe.scheduler.step(out_card, 901, x.to(DEVICE), None, STEPS, eta=0.0)
    cpu_s = time.perf_counter() - t0
    cmp = [card_vs_cpu("film_unet", out_card.cpu(), out_cpu, AUDIOLDM_CARD_CPU_LIMIT,
                       out_cpu.abs().max().item()),
           card_vs_cpu("ddim_step", step_card.cpu(), step_cpu, AUDIOLDM_CARD_CPU_LIMIT,
                       step_cpu.abs().max().item())]
    del cpu_unet, pipe, unet, rec, film, lat
    torch.cuda.empty_cache()

    # the CLI once, in its own process, on the checkpoint
    out_dir = os.path.join(root, "cli")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tango_tpu_torch.audioldm", "-t", AUDIOLDM_PROMPT, "--ckpt_path",
         ckpt, "--ddim_steps", str(AUDIOLDM_CLI_STEPS), "-n", str(AUDIOLDM_CLI_CANDIDATES),
         "-dur", str(AUDIOLDM_SECONDS), "-s", out_dir, "--device", DEVICE],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    cli_s = time.perf_counter() - t0
    names = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    pcm = read_int16(os.path.join(out_dir, names[0])) if names else np.zeros(0, np.int16)
    shutil.rmtree(root)
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in AUDIOLDM_PROMPT.replace(" ", "_"))
    if proc.returncode != 0:
        problems.append(f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    if names != [f"0_{safe[:60]}_0.wav"] or pcm.shape != (wav_len,) or \
            int(np.abs(pcm.astype(np.int32)).max()) == 0:
        problems.append(f"the CLI wrote {names}, {pcm.shape} samples")
    problems += [f"card vs CPU {c['what']}: {c['err']} over {c['limit']}" for c in cmp
                 if not c["ok"]]
    log("audioldm_cli", card_vs_cpu=cmp, card_vs_cpu_s=round(cpu_s, 3), cli_s=round(cli_s, 3),
        cli_files=names, cli_stub_warned="stub" in proc.stderr,
        phase_s=round(time.perf_counter() - t_phase, 3), problems=problems)
    if problems:
        raise AssertionError("audioldm: " + "; ".join(problems))
    return launches, shapes


# ------------------------------------------------------------------ the mesh

def mesh_sft_setup(job: dict, device, latent_sharder=None):
    """The full-width f32 SFT of phase mesh (b) and (d), built alike in every
    process: the remat'd UNet (sequence-parallel with `latent_sharder`), the
    seeded VAE with its encoder, and the trainer's configuration
    (accumulation 1, MESH_DP_UPDATES updates)."""
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.utils.init import init_random_

    diffusion = AudioDiffusion(job["unet_config"], job["scheduler_config"], snr_gamma=5.0,
                               uncondition=True, remat=True, latent_sharder=latent_sharder,
                               device=device)
    with torch.device("meta"):
        vae = AutoencoderKL(job["vae_config"], with_encoder=True)
    vae = init_random_(vae.to_empty(device=device),
                       torch.Generator(device=device).manual_seed(2)).eval()
    return diffusion, vae.requires_grad_(False), job["train_config"]


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN's convolutions without TF32 inside (phase mesh (b), and (a)'s
    second f32 reading): with TF32,
    one process at batch 2 and two ranks at batch 1 take differently rounded
    convolutions, and Adam's first updates turn that 1e-4 on a near-zero
    gradient into a sign, which is TF32's batch-size noise and not the
    data-parallel step (scripts/mesh_tf32_probe.py)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def mesh_unet_inputs(unet, latent: tuple, batch: int, text_len: int, dtype, device, seed: int):
    """Seeded UNet inputs at latent (T, F): (latents, timesteps, context,
    mask)."""
    g = torch.Generator(device=device).manual_seed(seed)
    cfg = unet.cfg
    lat = torch.randn(batch, *latent, cfg.in_channels, generator=g, device=device)
    ctx = torch.randn(batch, text_len, cfg.cross_attention_dim, generator=g, device=device)
    t = torch.full((batch,), 500, dtype=torch.long, device=device)
    return lat, t, ctx.to(dtype), torch.ones(batch, text_len, dtype=torch.long, device=device)


def ms_per_step(model, batch: int, text_len: int, device, reps: int = 3,
                latent: tuple | None = None) -> float:
    """Host ms of one evaluation of the pipeline model's UNet at CFG batch
    `batch` (at latent (T, F), the model's by default), ended by a
    synchronize: under TP and SP its collectives run on the host too."""
    unet = model.unet
    args = mesh_unet_inputs(unet, latent or (model.latent_t_size, model.latent_f_size), batch,
                            text_len, unet.conv_in.weight.dtype, device, 5)
    with torch.inference_mode():
        unet(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            unet(*args)
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def mesh_rank_tp(job: dict, mesh, ops) -> dict:
    """Phase mesh (a), one rank of TP = 2: the f32 UNet at batch 1 against the
    same rank's unsharded UNet, with cuDNN's TF32 convolutions (its default)
    and in f32 convolutions (`f32_convolutions`), then Tango(snapshot, mesh=)
    in bf16: generate_for_batch of MESH_PROMPTS (CFG batch 8) and the ms a
    step at CFG batch 2."""
    from tango_tpu_torch.models.unet import UNet2DConditionModel
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.pipeline import Tango, build_module
    from tango_tpu_torch.utils.checkpoint import load_main_weights

    dev = mesh.device
    main = load_main_weights(job["snapshot"])
    unet = build_module(lambda: UNet2DConditionModel(main["unet_config"]), main["unet_params"],
                        dev, torch.float32, 0)
    del main
    args = mesh_unet_inputs(unet, job["latent"], 1, 128, torch.float32, dev, 3)
    with torch.inference_mode():
        ref = unet(*args).float()
        with f32_convolutions():
            ref_f32 = unet(*args).float()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the default tokenizer's warning
        tango = Tango(job["snapshot"], mesh=mesh, device=dev)
    tango.model.latent_t_size, tango.model.latent_f_size = job["latent"]
    latents = []
    decode = tango.decode

    def kept_decode(lat):
        latents.append(lat.float().cpu())
        return decode(lat)

    tango.decode = kept_decode
    tango.generate("warm up", steps=1, seed=1)
    latents.clear()
    torch.cuda.synchronize()
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    pmesh.shard_params(unet, mesh)
    with torch.inference_mode():
        out = unet(*args).float()
        with f32_convolutions():
            out_f32 = unet(*args).float()
    f32_err = float((out - ref).abs().max() / ref.abs().max())
    f32_conv_err = float((out_f32 - ref_f32).abs().max() / ref_f32.abs().max())
    del unet, out, ref, out_f32, ref_f32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = tango.generate_for_batch(MESH_PROMPTS, steps=job["steps"],
                                    batch_size=len(MESH_PROMPTS), seed=MESH_SEED)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    ms = {"cfg_batch_2": ms_per_step(tango.model, 2, tango.max_text_length, dev)}
    heads = sorted({m.local_heads for m in tango.model.unet.modules()
                    if hasattr(m, "local_heads")})
    return {"f32_rel_err": f32_err, "f32_conv_rel_err": f32_conv_err,
            "latents": torch.cat(latents), "generate_s": gen_s,
            "ms_per_step": ms, "local_heads": heads,
            "wavs": [(str(w.dtype), list(w.shape), int(abs(w.astype("int32")).max()))
                     for w in wavs]}


def mesh_rank_dp(job: dict, mesh, ops) -> dict:
    """Phase mesh (b), one rank of DP = 2: the full-width f32 SFT at batch 1 a
    rank, MESH_DP_UPDATES updates on the parent's global batches; rank 0
    holds the updated parameters to the one-process run's."""
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.train.sft import SFTTrainer

    dev = mesh.device
    diffusion, vae, cfg = mesh_sft_setup(job, dev)
    trainer = SFTTrainer(diffusion, vae, cfg, total_steps=MESH_DP_UPDATES, mesh=mesh)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    reduce_s = []
    hook = state.opt_state.before_update

    def timed_reduce(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hook(params)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    state.opt_state.before_update = timed_reduce
    batches = torch.load(os.path.join(job["work"], "dp_batches.pt"))
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for batch in batches:
        local = pmesh.shard_batch({k: v.to(dev) for k, v in batch.items()}, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, local, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    out = {"losses": losses, "ms_per_update": [1e3 * s for s in step_s],
           "all_reduce_ms": [1e3 * s for s in reduce_s]}
    if mesh.is_main:
        ref = torch.load(os.path.join(job["work"], "dp_ref.pt"), map_location="cpu")
        bound = MESH_PARAM_LR_FACTOR * cfg.learning_rate
        worst, over = 0.0, 0
        for k, v in trainer.state_dict(state).items():
            d = (v.float() - ref[k].to(dev).float()).abs()
            worst = max(worst, float(d.max()))
            over += int((d > bound).sum())
        out.update(param_max_abs_diff=worst, param_max_share_of_bound=worst / bound,
                   params_over_bound=over)
    return out


def mesh_rank_dp_f32(job: dict, mesh, ops) -> dict:
    with f32_convolutions():
        return mesh_rank_dp(job, mesh, ops)


def mesh_rank_sp(job: dict, mesh, ops) -> dict:
    """Phase mesh (d), one rank of SP = 2 over the long clip's latents
    (job["sp_latent"]): the snapshot's f32 UNet at batch 1 against the same
    rank's meshless evaluation, in f32 convolutions (`f32_convolutions`) and
    with cuDNN's TF32 ones; then the UNet in the parent pipeline's dtype
    (bf16: its weights): one evaluation at batch 1 against its meshless one
    (relative L2, beside the meshless one's from the f32 evaluation: the
    dtype's own noise), and in AudioDiffusion(latent_sharder=) a sample of
    PROMPT's encodings at MESH_SEED, MESH_SP_STEPS DDPM steps at CFG batch
    2, and the ms a step. The counters are zeroed after the meshless
    evaluations, so the part's launches are SP's. The collectives of an
    evaluation by kind, and the bytes this rank received, from the mesh's
    `seq_stats`. Then the bf16 UNet quantized (`sp_int8_eval`, path
    `sp_int8`) and the training step (`sp_train_step`, path `sp_train`),
    each counted on its own."""
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.unet import UNet2DConditionModel
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.pipeline import build_module
    from tango_tpu_torch.utils.checkpoint import load_main_weights

    dev = mesh.device
    main = load_main_weights(job["snapshot"])
    params = main["unet_params"]  # the int8 evaluation's and training step's starting weights
    cfg = main["unet_config"]
    unet = build_module(lambda: UNet2DConditionModel(cfg), params, dev, torch.float32, 0)
    del main
    args = mesh_unet_inputs(unet, job["sp_latent"], 1, 128, torch.float32, dev, 3)
    low = copy.deepcopy(unet).to(job["sp_dtype"])
    args_low = (args[0], args[1], args[2].to(job["sp_dtype"]), args[3])
    with torch.inference_mode():
        ref = unet(*args).float()
        with f32_convolutions():
            ref_f32 = unet(*args).float()
        ref_low = low(*args_low).float()
    torch.cuda.synchronize()
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    sharder = functools.partial(pmesh.shard_latents_seq, mesh=mesh)
    unet.latent_sharder = sharder
    with torch.inference_mode():
        out = unet(*args).float()
        with f32_convolutions():
            out_f32 = unet(*args).float()
    f32_stats = {k: v / 2 for k, v in mesh.seq_stats.items()}
    mesh.seq_stats.clear()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    del unet
    low.latent_sharder = sharder
    with torch.inference_mode():
        out_low = low(*args_low).float()
    mesh.seq_stats.clear()
    out_rec = {"f32_rel_err": rel(out, ref), "f32_conv_rel_err": rel(out_f32, ref_f32),
               "f32_out": out_f32.cpu(), "f32_collectives": f32_stats,
               "low_rel_l2": rel_l2(out_low, ref_low), "low_floor_rel_l2": rel_l2(ref_low, ref)}
    del out, ref, out_f32, ref_f32, out_low, ref_low
    diff = AudioDiffusion(low, job["scheduler_config"],
                          latent_t_size=job["sp_latent"][0], latent_f_size=job["sp_latent"][1],
                          dtype=job["sp_dtype"], latent_sharder=sharder)
    text = {k: v.to(dev) for k, v in torch.load(os.path.join(job["work"], "sp_text.pt")).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lat = diff.sample(text["cond"], text["mask"],
                          [torch.Generator(device=dev).manual_seed(MESH_SEED)],
                          num_steps=MESH_SP_STEPS, guidance_scale=3.0,
                          uncond_embeds=text["uncond"], uncond_mask=text["umask"])
    torch.cuda.synchronize()
    out_rec.update(sample_s=time.perf_counter() - t0, latents=lat.float().cpu(),
                   bf16_collectives={k: v / MESH_SP_STEPS for k, v in mesh.seq_stats.items()})
    out_rec["ms_per_step"] = {"cfg_batch_2": ms_per_step(diff, 2, 128, dev, reps=1,
                                                         latent=job["sp_latent"])}
    del diff, low
    torch.cuda.synchronize()
    out_rec.update(zip(("launches", "shapes", "tc", "cluster"), read_counters(ops)),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    out_rec["int8"] = sp_int8_eval(job, mesh, ops, cfg, params)
    torch.cuda.empty_cache()
    out_rec["train"] = sp_train_step(job, mesh, ops, params)
    return out_rec


def sp_int8_eval(job: dict, mesh, ops, cfg, params: dict) -> dict:
    """Phase mesh (d)'s int8 evaluation (line `mesh_sp_int8`), one rank of
    SP = 2: the snapshot's UNet quantized as Tango.from_components(quant=
    "all") serves it (its f32 weights quantized: int8 weights, f32 scales;
    the float remainder cast to the pipeline's dtype, bf16), at CFG batch 2
    over the long clip's latents, meshless (a warm-up, then a timed call),
    then with latent_sharder=partial(shard_latents_seq, mesh=mesh), whose
    first call is counted (the counters and the mesh's exchanges zeroed just
    before it and read just after: path `sp_int8`) and timed, and a second
    timed warm. Its relative L2 from the meshless output; the exchanges by
    kind, which must hold one `int8_amax` for each QConv2d (every level runs
    on slabs at 512 frames); each int8 convolution kind
    (`int8_layer_checks`) on the slabs against the meshless layer, bit for
    bit; and the same with each slab quantized by its own amax
    (`slab_amax_control`). The relative L2 is read, not held: at full width
    any difference in a layer's input (the slabs' GroupNorm sums in another
    order) moves some activations across an int8 rounding boundary and
    re-draws the quantization noise downstream, and the control lands at
    the same noise, so the layer checks and the amax count hold SP's int8
    path."""
    from tango_tpu_torch.models.unet import UNet2DConditionModel
    from tango_tpu_torch.ops.quant import QConv2d, quantize_unet_
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.pipeline import _cast_float_, build_module

    unet = quantize_unet_(build_module(lambda: UNet2DConditionModel(cfg), params, mesh.device,
                                       torch.float32, 0), "all")
    unet.cfg = dataclasses.replace(cfg, quant_int8=True, quant_scope="all")
    _cast_float_(unet, job["sp_dtype"])
    sharder = functools.partial(pmesh.shard_latents_seq, mesh=mesh)

    def timed(model, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*args).float()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    args = mesh_unet_inputs(unet, job["sp_latent"], 2, 128, job["sp_dtype"], mesh.device, 7)
    with torch.inference_mode():
        unet(*args)
        ref, ref_ms = timed(unet, args)
        unet.latent_sharder = sharder
        torch.cuda.synchronize()
        ops.reset_counters()
        mesh.seq_stats.clear()
        out, first_ms = timed(unet, args)
        counters = read_counters(ops)
        stats = dict(mesh.seq_stats)
        _, ms = timed(unet, args)
        layers = int8_layer_checks(unet, mesh, job["sp_dtype"], job["sp_latent"])
        control, control_layers = slab_amax_control(unet, args, mesh, job)
    return dict(zip(("launches", "shapes", "tc", "cluster"), counters), out=out.cpu(),
                rel_l2=rel_l2(out, ref), finite=bool(torch.isfinite(out).all()), ms=ms,
                first_ms=first_ms, meshless_ms=ref_ms, collectives=stats, layers=layers,
                control_rel_l2=rel_l2(control, ref), control_layers=control_layers,
                qconv=sum(isinstance(m, QConv2d) for m in unet.modules()))


def slab_amax_control(unet, args, mesh, job: dict):
    """The fault the amax all-reduce prevents, planted: the SP evaluation and
    `int8_layer_checks` again with each int8 conv quantizing its slab by the
    slab's own amax (`_slab_amax` without the exchange). (its output, its
    layer checks); the layers must differ from the meshless ones."""
    from tango_tpu_torch.models import unet as unet_mod
    from tango_tpu_torch.ops.quant import QConv2d, act_amax

    exchanged = unet_mod._slab_amax
    unet_mod._slab_amax = lambda conv, x, sp: act_amax(x) if isinstance(conv, QConv2d) else None
    try:
        out = unet(*args).float()
        return out, int8_layer_checks(unet, mesh, job["sp_dtype"], job["sp_latent"])
    finally:
        unet_mod._slab_amax = exchanged


def int8_layer_checks(unet, mesh, dtype, latent: tuple) -> dict:
    """Each int8 convolution path of the quantized UNet at its full-width
    shape on the long clip's slabs (a 3x3 resnet conv, a 1x1 shortcut, a
    downsampler, an upsampler), on seeded activations whose per-sample amax
    lies in another slab than rank 0's for one sample: this rank's rows of
    the SP layer (its amax all-reduced, halo rows and pads quantized with
    it) against the meshless layer's on the whole, which must be bit-equal
    (the amax is exact, _int_mm's int32 sums exact, the dequantize
    elementwise). {kind: (equal, max abs difference)}."""
    from tango_tpu_torch.models.unet import seq_conv
    from tango_tpu_torch.parallel.mesh import slab_span

    levels = len(unet.cfg.block_out_channels)
    short = next(lv for lv in range(levels)
                 if getattr(getattr(unet, f"down_blocks_{lv}").resnets_0, "conv_shortcut"))
    conv = lambda m: lambda x, sp=None: seq_conv(m, x, sp)  # noqa: E731
    # (layer, its int8 conv, the level of its input)
    cases = {"conv3x3": (conv(unet.down_blocks_0.resnets_0.conv1),
                         unet.down_blocks_0.resnets_0.conv1, 0),
             "conv1x1": (conv(getattr(unet, f"down_blocks_{short}").resnets_0.conv_shortcut),
                         getattr(unet, f"down_blocks_{short}").resnets_0.conv_shortcut, short),
             "downsample": (unet.down_blocks_0.downsamplers_0,
                            unet.down_blocks_0.downsamplers_0.conv, 0),
             "upsample": (getattr(unet, f"up_blocks_{levels - 2}").upsamplers_0,
                          getattr(unet, f"up_blocks_{levels - 2}").upsamplers_0.conv, 1)}
    g = torch.Generator(device=mesh.device).manual_seed(9)
    out = {}
    for kind, (layer, qconv, level) in cases.items():
        shape = (2, qconv.weight.shape[1], latent[0] >> level, latent[1] >> level)
        x = torch.randn(*shape, generator=g, device=mesh.device).to(dtype)
        x[0, 1, -3, -1] = 8.0
        x[1, 2, 1, 0] = -8.0
        whole = layer(x)
        mine = layer(x.narrow(2, *slab_span(shape[2], mesh)).contiguous(), mesh)
        want = whole.narrow(2, *slab_span(whole.shape[2], mesh))
        out[kind] = (bool(torch.equal(mine, want)), float((mine.float() - want.float()).abs().max()))
    return out


def sp_train_step(job: dict, mesh, ops, params: dict) -> dict:
    """Phase mesh (d)'s training step, one rank of SP = 2: the snapshot's
    full-width f32 UNet (remat, min-SNR 5, uncondition) in SFTTrainer(mesh=)
    with latent_sharder=partial(shard_latents_seq, mesh=mesh), at batch 1 on
    the long clip's latents (the parent's sp_train_batch.pt: a 2048-frame
    fbank, PROMPT's encoding), accumulation 1, one AdamW update, in f32
    convolutions. The counters and the mesh's exchanges are zeroed just
    before the step and read just after (path `sp_train`). Rank 0 then takes
    the same step without a mesh (uncounted) and holds the SP step to it:
    the loss (MESH_LOSS_RTOL), the gradients' relative L2 over every
    parameter (MESH_SP_GRAD_REL_L2) and each updated parameter
    (MESH_PARAM_LR_FACTOR lr)."""
    from tango_tpu_torch.parallel import mesh as pmesh
    from tango_tpu_torch.train.sft import SFTTrainer

    dev = mesh.device
    batch = {k: v.to(dev) for k, v in
             torch.load(os.path.join(job["work"], "sp_train_batch.pt")).items()}

    def step(sharder, before=lambda: None):
        """(loss, the gradients AdamW took, the updated parameters, ms)."""
        diffusion, vae, cfg = mesh_sft_setup(job, dev, sharder)
        trainer = SFTTrainer(diffusion, vae, cfg, total_steps=1,
                             mesh=None if sharder is None else mesh)
        state = trainer.init_state(params=params)
        names = [n for n, _ in state.params.named_parameters()]
        grads = {}
        adamw = state.opt_state.opt.step

        def capture(*a, **kw):
            grads.update({n: p.grad for n, p in zip(names, state.opt_state.params)})
            return adamw(*a, **kw)

        state.opt_state.opt.step = capture
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
        with f32_convolutions():
            torch.cuda.synchronize()
            before()
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, batch, gen)
            torch.cuda.synchronize()
        return float(loss), grads, trainer.state_dict(state), 1e3 * (time.perf_counter() - t0)

    def zero():
        ops.reset_counters()
        mesh.seq_stats.clear()
        torch.cuda.reset_peak_memory_stats()

    loss, grads, new, ms = step(functools.partial(pmesh.shard_latents_seq, mesh=mesh), zero)
    out = dict(zip(("launches", "shapes", "tc", "cluster"), read_counters(ops)), loss=loss,
               ms_per_step=ms, collectives=dict(mesh.seq_stats),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not mesh.is_main:
        return out
    torch.cuda.empty_cache()
    ref_loss, ref_grads, ref_new, ref_ms = step(None)
    sq = lambda t: float(t.double().norm()) ** 2  # noqa: E731
    bound = MESH_PARAM_LR_FACTOR * job["train_config"].learning_rate
    drift = {k: (new[k].float() - v.float()).abs() for k, v in ref_new.items()}
    out.update(meshless_loss=ref_loss, meshless_ms_per_step=ref_ms,
               loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
               grad_rel_l2=math.sqrt(sum(sq(grads[k] - g) for k, g in ref_grads.items())
                                     / sum(sq(g) for g in ref_grads.values())),
               param_max_abs_diff=max(float(d.max()) for d in drift.values()),
               params_over_bound=sum(int(d.gt(bound).sum()) for d in drift.values()),
               param_bound=bound)
    return out


MESH_PARTS = {"tp": mesh_rank_tp, "dp": mesh_rank_dp_f32, "sp": mesh_rank_sp}


def mesh_rank_main(part: str, work: str) -> int:
    """A rank of phase mesh, started by `mesh_phase` with torchrun's
    variables: its part on the card, then its counters and results saved as
    <work>/<part>_rank<r>.pt for the parent."""
    from tango_tpu_torch import ops
    from tango_tpu_torch.ops import _build
    from tango_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    job = torch.load(os.path.join(work, "job.pt"), weights_only=False)
    rank, world, dev = pmesh.init_distributed(None if job["device"] == "cuda" else job["device"])
    if dev.type == "cuda":
        _build.load()
    else:  # a CPU rehearsal of the phase: the plain versions, no card to wait for
        for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    mesh = pmesh.make_mesh(data=job["parts"][part]["data"], model=job["parts"][part]["model"],
                           device=dev)
    out = MESH_PARTS[part](job, mesh, ops)
    torch.cuda.synchronize()
    if "launches" not in out:  # part sp reads its counters before its training step
        out.update(zip(("launches", "shapes", "tc", "cluster"), read_counters(ops)),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    out.update(rank=rank, world=world, backend=mesh.backend)
    torch.save(out, os.path.join(work, f"{part}_rank{rank}.pt"))
    return 0


def mesh_batches(job: dict, tango, work: str) -> list:
    """MESH_DP_UPDATES global batches of MESH_DP_BATCH rows for phase mesh (b):
    fbanks of seeded synthetic WAVs, captions through the pipeline's T5."""
    from tango_tpu_torch.train.data import FeaturizedLoader, load_manifest

    frames = job["target_length"]
    examples = load_manifest(write_wavs(os.path.join(work, "data"),
                                        MESH_DP_BATCH * MESH_DP_UPDATES, frames / 100, seed=4))
    out = []
    for raw in FeaturizedLoader(examples, MESH_DP_BATCH, target_length=frames, shuffle=False):
        embeds, mask = tango.encode_text(raw["captions"])
        out.append({"fbank": torch.as_tensor(raw["fbank"]), "text_embeds": embeds.float().cpu(),
                    "text_mask": mask.cpu()})
    return out


def long_clip_frames(model) -> int:
    """The latent frames of a LONG_CLIP_S clip, as Tango.generate rounds
    them (a multiple of the UNet's downsampling)."""
    factor = 2 ** (len(model.unet_config.block_out_channels) - 1)
    return factor * max(round(LONG_CLIP_S * 25.6 / factor), 1)


def mesh_phase(C, ops, tango, snap_dir: str, root: str) -> dict:
    """Phase mesh: the port's device mesh on the card, its ranks processes
    sharing the one card over gloo (parallel.launch with torchrun's
    variables). (a) TP = 2 serving of the snapshot in bf16 against this
    process's pipeline at the same seed, and an f32 UNet evaluation at batch 1
    against the rank's unsharded one; (b) DP = 2 full-width f32 SFT at batch
    1 a rank against one process at batch 2; (c) dryrun_multichip(4), the
    2 x 2 step of the dry run's tiny config; (d) SP = 2 over the long clip's
    latents (`mesh_rank_sp`) against the rank's meshless UNet and this
    process's sample. The launches, shapes and bodies of (a)-(c)'s ranks are
    summed into path `mesh`, (d)'s into path `sp`. Returns {path: (launches,
    shapes, tensor-core launches, cluster launches)}; raises on any failed
    check."""
    from tango_tpu_torch.parallel.dryrun import dryrun_multichip
    from tango_tpu_torch.parallel.launch import check, launch
    from tango_tpu_torch.train.data import FeaturizedLoader, load_manifest
    from tango_tpu_torch.train.sft import SFTTrainer

    t_phase = time.perf_counter()
    work = os.path.join(root, "mesh")
    os.makedirs(work, exist_ok=True)
    sp_latent = (long_clip_frames(tango.model), tango.model.latent_f_size)
    job = {"snapshot": snap_dir, "work": work, "device": DEVICE, "steps": MESH_TP_STEPS,
           "target_length": MESH_TARGET_LENGTH,
           "latent": (tango.model.latent_t_size, tango.model.latent_f_size),
           "sp_latent": sp_latent, "sp_dtype": tango.dtype,
           "unet_config": C.TANGO_UNET, "vae_config": C.TANGO_VAE,
           "scheduler_config": C.SD21_SCHEDULER,
           "train_config": C.TrainConfig(gradient_accumulation_steps=1,
                                         max_train_steps=MESH_DP_UPDATES),
           "parts": {"tp": {"data": 1, "model": 2}, "dp": {"data": 2, "model": 1},
                     "sp": {"data": 1, "model": 2}}}
    torch.save(job, os.path.join(work, "job.pt"))

    # one process: (a)'s latents and ms a step, (b)'s losses and parameters
    one = {}
    with torch.inference_mode():
        one["latents"] = tango.sample_latents(MESH_PROMPTS, MESH_TP_STEPS, 3.0, 1, MESH_SEED,
                                              0).cpu()
    wav_len = tango.decode_to_waveform(one["latents"][:1].to(DEVICE)).shape[1]
    one["ms_per_step"] = {"cfg_batch_2": ms_per_step(tango.model, 2, tango.max_text_length,
                                                     DEVICE)}
    # (d)'s: PROMPT's encodings, the long clip's sample and its ms a step
    with torch.inference_mode():
        cond, mask = tango.encode_text([PROMPT])
        uncond, umask = tango.encode_text([""])
        one["sp_latents"] = tango.model.sample(
            cond, mask, [torch.Generator(device=DEVICE).manual_seed(MESH_SEED)],
            num_steps=MESH_SP_STEPS, guidance_scale=3.0, uncond_embeds=uncond,
            uncond_mask=umask, latent_t_size=sp_latent[0]).float().cpu()
    torch.save({"cond": cond.cpu(), "mask": mask.cpu(), "uncond": uncond.cpu(),
                "umask": umask.cpu()}, os.path.join(work, "sp_text.pt"))
    # (d)'s training batch: one seeded clip's fbank at the long clip's length
    # (4 frames a latent frame), PROMPT's encoding
    frames = 4 * sp_latent[0]
    raw = next(iter(FeaturizedLoader(load_manifest(write_wavs(
        os.path.join(work, "sp_data"), 1, frames / 100, seed=6)), 1, target_length=frames,
        shuffle=False)))
    torch.save({"fbank": torch.as_tensor(raw["fbank"]), "text_embeds": cond.float().cpu(),
                "text_mask": mask.cpu()}, os.path.join(work, "sp_train_batch.pt"))
    one["sp_ms_per_step"] = {"cfg_batch_2": ms_per_step(tango.model, 2, tango.max_text_length,
                                                        DEVICE, latent=sp_latent)}
    batches = mesh_batches(job, tango, work)
    torch.save(batches, os.path.join(work, "dp_batches.pt"))
    diffusion, vae, cfg = mesh_sft_setup(job, DEVICE)
    trainer = SFTTrainer(diffusion, vae, cfg, total_steps=MESH_DP_UPDATES)
    state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    one["losses"], one["ms_per_update"] = [], []
    with f32_convolutions():
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, {k: v.to(DEVICE) for k, v in batch.items()},
                                             gen)
            torch.cuda.synchronize()
            one["ms_per_update"].append(1e3 * (time.perf_counter() - t0))
            one["losses"].append(float(loss))
    torch.save({k: v.cpu() for k, v in trainer.state_dict(state).items()},
               os.path.join(work, "dp_ref.pt"))
    del trainer, state, diffusion, vae
    torch.cuda.empty_cache()  # free this process's cache before the ranks start
    ref_s = time.perf_counter() - t_phase

    ranks, part_s = {}, {}
    for part in ("tp", "dp", "sp"):
        t0 = time.perf_counter()
        world = job["parts"][part]["data"] * job["parts"][part]["model"]
        results = launch([sys.executable, os.path.abspath(__file__), "--mesh-rank", part, work],
                         world, MESH_LAUNCH_TIMEOUT_S)
        check(results, f"phase mesh ({part})")
        ranks[part] = [torch.load(os.path.join(work, f"{part}_rank{r}.pt"), weights_only=False)
                       for r in range(world)]
        part_s[part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=None if DEVICE == "cuda" else DEVICE,
                           timeout=MESH_LAUNCH_TIMEOUT_S)
    part_s["dryrun"] = time.perf_counter() - t0

    # summed over the ranks under this process's names (a kernel that a rank
    # never imported, such as winograd_conv3x3, counts 0 there)
    names, _, tc_names, cluster_names = read_counters(ops)

    def summed(every):
        return ({n: sum(r["launches"].get(n, 0) for r in every) for n in names},
                {n: set().union(*(r["shapes"].get(n, set()) for r in every)) for n in names},
                {n: sum(r["tc"].get(n, 0) for r in every) for n in tc_names},
                {n: sum(r["cluster"].get(n, 0) for r in every) for n in cluster_names})

    paths = {"mesh": summed(ranks["tp"] + ranks["dp"]), "sp": summed(ranks["sp"]),
             "sp_int8": summed([r["int8"] for r in ranks["sp"]]),
             "sp_train": summed([r["train"] for r in ranks["sp"]])}
    launches, shapes, tc, cluster = paths["mesh"]
    tp0, dp0 = ranks["tp"][0], ranks["dp"][0]
    rel_l2 = float((tp0["latents"] - one["latents"]).norm() / one["latents"].norm())
    loss_err = [abs(a - b) / abs(b) for a, b in zip(dp0["losses"], one["losses"])]
    problems = body_problems("mesh", launches, tc, cluster)
    problems += sp_problems(ranks["sp"], one["sp_latents"], paths["sp"])
    problems += sp_int8_problems([r["int8"] for r in ranks["sp"]], paths["sp_int8"])
    problems += sp_train_problems([r["train"] for r in ranks["sp"]], paths["sp_train"])
    if rel_l2 > MESH_TP_REL_L2:
        problems.append(f"TP = 2 latents {rel_l2} (relative L2) from one process's")
    for key in ("f32_rel_err", "f32_conv_rel_err"):
        if max(r[key] for r in ranks["tp"]) > MESH_F32_LIMIT:
            problems.append(f"TP = 2 f32 UNet ({key}) {[r[key] for r in ranks['tp']]} from one "
                            "process's, of its largest magnitude")
    if any(list(w[:2]) != ["int16", [wav_len]] or not w[2]
           for r in ranks["tp"] for w in r["wavs"]) or len(tp0["wavs"]) != len(MESH_PROMPTS):
        problems.append(f"TP = 2 waveforms {tp0['wavs']}")
    if len(loss_err) != MESH_DP_UPDATES or max(loss_err) > MESH_LOSS_RTOL:
        problems.append(f"DP = 2 losses {dp0['losses']} against one process's {one['losses']}")
    if dp0["params_over_bound"]:
        problems.append(f"DP = 2: {dp0['params_over_bound']} parameters past "
                        f"{MESH_PARAM_LR_FACTOR} lr from one process's")
    update_ms = [statistics.mean(r["ms_per_update"]) for r in ranks["dp"]]
    reduce_ms = [statistics.mean(r["all_reduce_ms"]) for r in ranks["dp"]]
    log("mesh", card=nvidia_smi(), backend=tp0["backend"],
        world={"tp": len(ranks["tp"]), "dp": len(ranks["dp"]), "dryrun": 4},
        local_heads={f"tp_rank{r['rank']}": r["local_heads"] for r in ranks["tp"]},
        ms_per_unet_step={"tp2": [r["ms_per_step"] for r in ranks["tp"]],
                          "one_process": one["ms_per_step"]},
        tp_generate_s=[round(r["generate_s"], 3) for r in ranks["tp"]],
        tp_latents_rel_l2=rel_l2, tp_f32_rel_err=[r["f32_rel_err"] for r in ranks["tp"]],
        tp_f32_conv_rel_err=[r["f32_conv_rel_err"] for r in ranks["tp"]],
        dp_ms_per_update={"dp2": update_ms, "one_process_batch_2": one["ms_per_update"]},
        dp_all_reduce_ms=reduce_ms,
        dp_all_reduce_share=[a / u for a, u in zip(reduce_ms, update_ms)],
        dp_losses=dp0["losses"], one_process_losses=one["losses"], dp_loss_rel_err=loss_err,
        dp_param_max_abs_diff=dp0["param_max_abs_diff"],
        dp_param_max_share_of_bound=dp0["param_max_share_of_bound"],
        dp_param_bound=MESH_PARAM_LR_FACTOR * job["train_config"].learning_rate,
        dryrun=dry,
        peak_memory_bytes={f"{p}_rank{r['rank']}": r["peak_memory_bytes"]
                           for p, rs in ranks.items() for r in rs},
        launches_per_rank={f"{p}_rank{r['rank']}": {n: c for n, c in r["launches"].items() if c}
                           for p, rs in ranks.items() for r in rs},
        launches=launches, tc_launches=tc, cluster_launches=cluster,
        shapes={n: len(v) for n, v in shapes.items()},
        bounds={"tp_rel_l2": MESH_TP_REL_L2, "tp_f32": MESH_F32_LIMIT,
                "dp_loss_rtol": MESH_LOSS_RTOL, "dp_param_lr": MESH_PARAM_LR_FACTOR},
        reference_s=round(ref_s, 3), part_s={k: round(v, 3) for k, v in part_s.items()},
        phase_s=round(time.perf_counter() - t_phase, 3), problems=problems)
    sp_launches, sp_shapes, sp_tc, sp_cluster = paths["sp"]
    sp0 = ranks["sp"][0]
    log("mesh_sp", card=nvidia_smi(), backend=sp0["backend"], world=len(ranks["sp"]),
        latent=list(sp_latent), steps=MESH_SP_STEPS,
        ms_per_unet_step={"sp2": [r["ms_per_step"] for r in ranks["sp"]],
                          "one_process": one["sp_ms_per_step"]},
        sample_s=[round(r["sample_s"], 3) for r in ranks["sp"]],
        latents_rel_l2=float((sp0["latents"] - one["sp_latents"]).norm()
                             / one["sp_latents"].norm()),
        f32_rel_err=[r["f32_rel_err"] for r in ranks["sp"]],
        f32_conv_rel_err=[r["f32_conv_rel_err"] for r in ranks["sp"]],
        bf16_eval_rel_l2=sp0["low_rel_l2"], bf16_meshless_vs_f32_rel_l2=sp0["low_floor_rel_l2"],
        collectives_per_eval={"f32_batch_1": sp0["f32_collectives"],
                              "bf16_cfg_batch_2": sp0["bf16_collectives"]},
        peak_memory_bytes=[r["peak_memory_bytes"] for r in ranks["sp"]],
        launches={n: c for n, c in sp_launches.items() if c}, tc_launches=sp_tc,
        cluster_launches=sp_cluster, shapes={n: len(v) for n, v in sp_shapes.items() if v},
        bounds={"f32_conv": MESH_SP_F32_LIMIT, "f32": MESH_F32_LIMIT,
                "latents_rel_l2": MESH_TP_REL_L2},
        part_s=round(part_s["sp"], 3),
        total_s_since_phase=round(time.perf_counter() - t_phase, 3))
    q0 = ranks["sp"][0]["int8"]
    q_launches, q_shapes, q_tc, q_cluster = paths["sp_int8"]
    log("mesh_sp_int8", card=nvidia_smi(), latent=list(sp_latent), batch=2, scope="all",
        rel_l2=[r["int8"]["rel_l2"] for r in ranks["sp"]],
        control_rel_l2=[r["int8"]["control_rel_l2"] for r in ranks["sp"]],
        control_layers={f"rank{r['rank']}": r["int8"]["control_layers"] for r in ranks["sp"]},
        layers={f"rank{r['rank']}": r["int8"]["layers"] for r in ranks["sp"]},
        ms_per_eval={"sp2": [r["int8"]["ms"] for r in ranks["sp"]],
                     "sp2_first": [r["int8"]["first_ms"] for r in ranks["sp"]],
                     "meshless": [r["int8"]["meshless_ms"] for r in ranks["sp"]]},
        collectives_per_eval=q0["collectives"], qconv2d=q0["qconv"],
        launches={n: c for n, c in q_launches.items() if c}, tc_launches=q_tc,
        cluster_launches=q_cluster, shapes={n: len(v) for n, v in q_shapes.items() if v},
        w8a8_gemms=sorted([m, k, n] for (m, k), (n, _) in q_shapes["w8a8_matmul"]))
    train0 = ranks["sp"][0]["train"]
    tr_launches, tr_shapes, tr_tc, tr_cluster = paths["sp_train"]
    log("mesh_sp_train", card=nvidia_smi(), latent=list(sp_latent), batch=1,
        ms_per_step={"sp2": [r["train"]["ms_per_step"] for r in ranks["sp"]],
                     "one_process": train0["meshless_ms_per_step"]},
        losses=[r["train"]["loss"] for r in ranks["sp"]], meshless_loss=train0["meshless_loss"],
        loss_rel_err=train0["loss_rel_err"], grad_rel_l2=train0["grad_rel_l2"],
        param_max_abs_diff=train0["param_max_abs_diff"],
        param_max_share_of_bound=train0["param_max_abs_diff"] / train0["param_bound"],
        params_over_bound=train0["params_over_bound"],
        collectives_per_step=train0["collectives"],
        peak_memory_bytes=[r["train"]["peak_memory_bytes"] for r in ranks["sp"]],
        launches={n: c for n, c in tr_launches.items() if c}, tc_launches=tr_tc,
        cluster_launches=tr_cluster, shapes={n: len(v) for n, v in tr_shapes.items() if v},
        bounds={"loss_rtol": MESH_LOSS_RTOL, "grad_rel_l2": MESH_SP_GRAD_REL_L2,
                "param": train0["param_bound"]})
    shutil.rmtree(work)
    if problems:
        raise AssertionError("; ".join(problems))
    return paths


def sp_problems(ranks: list, one_latents, path: tuple) -> list:
    """Phase mesh (d)'s failed checks: each rank's f32 evaluation against its
    meshless one (MESH_SP_F32_LIMIT in f32 convolutions, MESH_F32_LIMIT with
    TF32), its bf16 latents against one process's (MESH_TP_REL_L2), finite;
    the ranks' f32 outputs and latents bit-equal; path `sp`'s kernels
    (PATH_KERNELS["sp"] launched, SP_IDLE_KERNELS not, every attention on
    its tensor-core body)."""
    problems = []
    for r in ranks:
        if not (r["f32_conv_rel_err"] <= MESH_SP_F32_LIMIT
                and r["f32_rel_err"] <= MESH_F32_LIMIT):
            problems.append(f"SP = 2 rank {r['rank']}: f32 UNet {r['f32_conv_rel_err']} (f32 "
                            f"convolutions), {r['f32_rel_err']} (TF32) from the meshless one's, "
                            "of its largest magnitude")
        rel = float((r["latents"] - one_latents).norm() / one_latents.norm())
        if not rel <= MESH_TP_REL_L2 or not bool(torch.isfinite(r["latents"]).all()):
            problems.append(f"SP = 2 rank {r['rank']}: latents {rel} (relative L2) from one "
                            "process's")
    if not all(torch.equal(r[k], ranks[0][k]) for r in ranks for k in ("f32_out", "latents")):
        problems.append("SP = 2: the ranks' gathered outputs differ")
    launches, _, tc, cluster = path
    problems += body_problems("sp", launches, tc, cluster)
    busy = {n: launches[n] for n in SP_IDLE_KERNELS if launches[n]}
    if busy:
        problems.append(f"SP = 2 launched {busy}: its GroupNorms need statistics across slabs")
    return problems


def sp_int8_problems(evals: list, path: tuple) -> list:
    """Phase mesh (d)'s int8 evaluation's failed checks: each rank's output
    finite, each int8 convolution path bit-equal to the meshless layer and,
    under the control, not bit-equal, the ranks' outputs bit-equal, one
    `int8_amax` exchange for each QConv2d; path
    `sp_int8`'s kernels (PATH_KERNELS["sp_int8"] launched, SP_IDLE_KERNELS
    not, every w8a8_matmul and attention launch on its tensor-core body)."""
    problems = []
    for r, e in enumerate(evals):
        if not e["finite"]:
            problems.append(f"SP = 2 int8 rank {r}: output not finite")
        off = {k: v for k, v in e["layers"].items() if not v[0]}
        if off:
            problems.append(f"SP = 2 int8 rank {r}: layers not bit-equal to meshless: {off}")
        blind = [k for k, v in e["control_layers"].items() if v[0]]
        if blind:
            problems.append(f"SP = 2 int8 rank {r}: with each slab's own amax, layers {blind} "
                            "still bit-equal to meshless: the layer check cannot see the fault")
        if e["collectives"].get("int8_amax") != e["qconv"]:
            problems.append(f"SP = 2 int8 rank {r}: {e['collectives'].get('int8_amax')} amax "
                            f"all-reduces for {e['qconv']} QConv2d")
    if not all(torch.equal(e["out"], evals[0]["out"]) for e in evals):
        problems.append("SP = 2 int8: the ranks' gathered outputs differ")
    launches, _, tc, cluster = path
    problems += body_problems("sp_int8", launches, tc, cluster)
    busy = {n: launches[n] for n in SP_IDLE_KERNELS if launches[n]}
    if busy:
        problems.append(f"SP = 2 int8 launched {busy}: its GroupNorms need statistics across "
                        "slabs")
    return problems


def sp_train_problems(train: list, path: tuple) -> list:
    """Phase mesh (d)'s training step's failed checks: rank 0's step against
    its meshless one (the loss within MESH_LOSS_RTOL, the gradients' relative
    L2 within MESH_SP_GRAD_REL_L2, no parameter past MESH_PARAM_LR_FACTOR
    lr), every rank's loss the same and finite; path `sp_train`'s kernels
    (PATH_KERNELS["sp_train"] launched, SP_TRAIN_IDLE_KERNELS not, every
    attention on its tensor-core body, every gn_bwd_stats launch on its
    cluster body and every gn_bwd_apply launch on its flat body)."""
    t0, problems = train[0], []
    if not (math.isfinite(t0["loss"]) and len({t["loss"] for t in train}) == 1):
        problems.append(f"SP = 2 training losses {[t['loss'] for t in train]}")
    if not t0["loss_rel_err"] <= MESH_LOSS_RTOL:
        problems.append(f"SP = 2 training loss {t0['loss']} against {t0['meshless_loss']} "
                        "without a mesh")
    if not t0["grad_rel_l2"] <= MESH_SP_GRAD_REL_L2:
        problems.append(f"SP = 2 gradients {t0['grad_rel_l2']} (relative L2) from the meshless "
                        "step's")
    if t0["params_over_bound"]:
        problems.append(f"SP = 2: {t0['params_over_bound']} parameters past "
                        f"{MESH_PARAM_LR_FACTOR} lr from the meshless step's")
    launches, _, tc, cluster = path
    problems += body_problems("sp_train", launches, tc, cluster)
    busy = {n: launches[n] for n in SP_TRAIN_IDLE_KERNELS if launches[n]}
    if busy:
        problems.append(f"SP = 2 training launched {busy}: its GroupNorms' backward needs "
                        "sums across slabs")
    return problems


def train_phase(C, ops) -> tuple[dict, dict, dict, dict]:
    """One full-width f32 SFTTrainer.fit on the card: 4 micro-steps at batch
    2 with accumulation 2 (2 updates), one validation batch, the best
    checkpoint saved, loaded back and deleted. Returns the launches, shapes,
    tensor-core launches and cluster launches of the counted run; raises on
    any failed check."""
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.t5 import T5Encoder
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.tokenizer import WordHashTokenizer
    from tango_tpu_torch.train import sft
    from tango_tpu_torch.train.data import FeaturizedLoader, load_manifest, validate_manifest
    from tango_tpu_torch.utils.checkpoint import load_native
    from tango_tpu_torch.utils.init import init_random_

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def frozen(make):
        with torch.device("meta"):
            m = make()
        return init_random_(m.to_empty(device=DEVICE), gen).eval().requires_grad_(False)

    diffusion = AudioDiffusion(C.TANGO_UNET, C.SD21_SCHEDULER, snr_gamma=5.0, uncondition=True,
                               remat=True, device=DEVICE)
    vae = frozen(lambda: AutoencoderKL(C.TANGO_VAE, with_encoder=True))
    t5 = frozen(lambda: T5Encoder(C.FLAN_T5_LARGE))
    cfg = C.TrainConfig(gradient_accumulation_steps=2, max_train_steps=2,
                        per_device_train_batch_size=TRAIN_BATCH, augment=False)
    trainer = sft.SFTTrainer(diffusion, vae, cfg, total_steps=cfg.max_train_steps)
    state = trainer.init_state(gen)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in diffusion.unet.parameters())
    log("train_model", seconds=round(time.perf_counter() - t0, 3), unet_params=n_unet,
        dtype=str(diffusion.unet.conv_in.weight.dtype))

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    examples = load_manifest(write_wavs(os.path.join(root, "data"), TRAIN_WAVS, 10.24, seed=0))
    validate_manifest(examples)
    tok = WordHashTokenizer(C.FLAN_T5_LARGE.vocab_size)
    train_batches = sft.encode_batches(
        FeaturizedLoader(examples, TRAIN_BATCH, target_length=1024, seed=0), tok, t5)
    val_batches = sft.encode_batches(
        FeaturizedLoader(examples[:TRAIN_BATCH], TRAIN_BATCH, target_length=1024,
                         shuffle=False), tok, t5)

    # watch each micro-step: its loss, its time, and one parameter tensor
    watched = diffusion.unet.conv_in.weight
    micro = []  # (seconds, loss, watched parameter changed since the last step)
    step, save = trainer.train_step, sft.save_native
    saves = []

    def timed_step(st, batch, generator=None):
        before = watched.detach().clone()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = step(st, batch, generator)
        torch.cuda.synchronize()
        micro.append((time.perf_counter() - s0, float(out[1]),
                      not torch.equal(before, watched.detach())))
        return out

    def timed_save(*a, **kw):
        s0 = time.perf_counter()
        save(*a, **kw)
        saves.append(time.perf_counter() - s0)

    records = []
    trainer.train_step, sft.save_native = timed_step, timed_save
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(state, train_batches, val_batches, gen, os.path.join(root, "run"),
                        num_epochs=1, log_fn=records.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, shapes, tc, cluster = read_counters(ops)
    trainer.train_step, sft.save_native = step, save

    problems = []
    losses = [m[1] for m in micro] + [r["val_loss"] for r in records]
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"non-finite loss: {losses}")
    if [m[2] for m in micro] != [False, True, False, True]:
        problems.append(f"parameters changed after micro-steps {[m[2] for m in micro]}, "
                        "expected after the 2nd and 4th only")
    if state.step != 4 or state.opt_state.updates != 2 or len(records) != 1:
        problems.append(f"{state.step} micro-steps, {state.opt_state.updates} updates, "
                        f"{len(records)} validations: expected 4, 2, 1")
    t0 = time.perf_counter()
    best, manifest = load_native(os.path.join(root, "run", "best"))
    load_s = time.perf_counter() - t0
    live = diffusion.unet.state_dict()
    if set(best) != set(live) or not all(torch.equal(best[k], live[k].cpu()) for k in live):
        problems.append("the best checkpoint does not load back bit-equal")
    del best
    shutil.rmtree(root)
    # every attention of training is f32 at head dim 64: the forward's on the
    # 3xTF32 body, the backward's on theirs; every single-pass GroupNorm and
    # GroupNorm backward on its cluster body
    problems += body_problems("train", launches, tc, cluster)
    log("train", fit_s=round(fit_s, 3), micro_steps=len(micro), tc_launches=tc,
        cluster_launches=cluster,
        ms_per_micro_step=[round(1e3 * m[0], 3) for m in micro],
        losses=[m[1] for m in micro], val_loss=[r["val_loss"] for r in records],
        peak_memory_bytes=peak, checkpoint_save_s=[round(v, 3) for v in saves],
        checkpoint_load_s=round(load_s, 3), checkpoint_manifest=manifest, launches=launches,
        launches_per_micro_step={n: c / max(len(micro), 1) for n, c in launches.items()},
        shapes={n: len(v) for n, v in shapes.items()}, problems=problems)
    if problems:
        raise AssertionError("; ".join(problems))
    del trainer, state, diffusion, vae, t5
    torch.cuda.empty_cache()
    return launches, shapes, tc, cluster


def main(argv) -> int:
    if argv[:1] == ["--mesh-rank"]:  # a rank of phase mesh, started by mesh_phase
        return mesh_rank_main(argv[1], argv[2])
    if argv[:1] == ["--ingest"]:  # phase ingest's child, started by ingest_phase
        return ingest_child(argv[1])
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    detail = "--detail" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from tango_tpu_torch import configs as C
    from tango_tpu_torch import ops
    from tango_tpu_torch.ops import _build
    from tango_tpu_torch.ops.quant import QLinear
    from tango_tpu_torch.ops.winograd import wino_supported
    from tango_tpu_torch.pipeline import Tango

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 versions stay f32

    smi = nvidia_smi()
    log("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    _build.load()
    log("build", seconds=round(_build.build_info["seconds"], 3),
        reused=_build.build_info["reused"], library=os.path.basename(_build.build_info["path"]))
    ingest = ingest_phase(os.path.join(os.path.dirname(_build.build_info["path"]),
                                       "smoke_ingest.json"))

    t0 = time.perf_counter()
    tango = Tango.from_components(
        unet_config=C.TANGO_UNET, vae_config=C.TANGO_VAE, t5_config=C.FLAN_T5_LARGE,
        hifigan_config=C.TANGO_HIFIGAN, scheduler_config=C.SD21_SCHEDULER, device=DEVICE,
        init_seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (tango.model.unet, tango.t5, tango.vae, tango.vocoder)
                   for p in m.parameters())
    log("model", seconds=round(time.perf_counter() - t0, 3), params=n_params,
        dtype=str(tango.dtype))

    t0 = time.perf_counter()
    tango.generate("warm up", steps=1, seed=1)
    torch.cuda.synchronize()
    log("warmup", seconds=round(time.perf_counter() - t0, 3))

    # ---- the serving paths, each counted on its own
    checks = {}
    tc_launches = {}  # path -> tensor-core launches of each kernel that has such a body
    cluster_launches = {}  # path -> cluster launches of each kernel that has such a body
    sample_times = {}  # CFG batch of the UNet -> [seconds, steps]
    first_latents = {}  # path -> the latents of its first decode
    first_wavs = {}  # path -> its first waveform

    def instrument(t):
        """Check every decode of pipeline t and time every sampling loop;
        returns the function that takes the instruments off again."""
        decode, sample = t.decode, t.model.sample

        def checked_decode(latents):
            checks["latents_finite"] &= bool(torch.isfinite(latents).all())
            first_latents.setdefault(checks["path"], latents.float().clone())
            mel, wav = decode(latents)
            checks["mel_finite"] &= bool(torch.isfinite(mel.float()).all())
            return mel, wav

        def timed_sample(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = sample(*a, **kw)
            torch.cuda.synchronize()
            rec = sample_times.setdefault(2 * out.shape[0], [0.0, 0])
            rec[0] += time.perf_counter() - s0
            rec[1] += kw["num_steps"]
            return out

        t.decode, t.model.sample = checked_decode, timed_sample

        def remove():
            t.decode, t.model.sample = decode, sample
        return remove

    def counted(path, drive, expect_len, phase=None, extra=None):
        """Zero the counters, run `drive` (-> waveforms, seconds by call), read
        the counters; check the waveforms and that the path's kernels ran; log
        it as `phase` (the path's name by default), with the fields
        `extra(launches)` adds."""
        checks.update(latents_finite=True, mel_finite=True, path=path)
        sample_times.clear()
        ops.reset_counters()
        outs, seconds = drive()
        torch.cuda.synchronize()
        first_wavs[path] = outs[0]
        launches, shapes, tc, cluster = read_counters(ops)
        problems = []
        if path in TC_PATHS or path in CORE_ATTN_PATHS:
            problems += tc_problems(path, launches, tc)
        problems += off_cluster(cluster, launches)
        # one length for every waveform, or one a waveform
        lens = list(expect_len) if isinstance(expect_len, (list, tuple)) else \
            [expect_len] * len(outs)
        if len(lens) != len(outs):
            problems.append(f"{len(outs)} waveforms, {len(lens)} expected")
        for w, n in zip(outs, lens):
            if w.dtype.name != "int16" or w.shape != (n,):
                problems.append(f"waveform {w.dtype} {w.shape}, expected int16 ({n},)")
            if int(abs(w.astype("int32")).max()) == 0:
                problems.append("a silent waveform")
        if not (checks["latents_finite"] and checks["mel_finite"]):
            problems.append(f"non-finite values: {checks}")
        idle = [n for n in PATH_KERNELS.get(path, ()) if launches[n] == 0]
        if idle:
            problems.append(f"kernels never launched on the {path} path: {idle}")
        log(phase or path, **{f"{k}_s": round(v, 3) for k, v in seconds.items()},
            ms_per_unet_step={f"cfg_batch_{b}": round(1e3 * t / n, 3)
                              for b, (t, n) in sorted(sample_times.items())},
            launches=launches, tc_launches=tc, cluster_launches=cluster,
            shapes={n: len(v) for n, v in shapes.items()},
            wav_len=expect_len, peak=[int(abs(w.astype("int32")).max()) for w in outs],
            **(extra(launches) if extra else {}), problems=problems)
        if problems:
            raise AssertionError("; ".join(problems))
        tc_launches[path] = tc
        cluster_launches[path] = cluster
        return launches, shapes

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def single(t, steps=STEPS, **kw):
        """One generate of PROMPT at seed 0 through pipeline t."""
        def drive():
            wav, t_gen = timed(lambda: t.generate(PROMPT, steps=steps, seed=0, **kw))
            return [wav], {"generate": t_gen}
        return drive

    def serve():
        wav, t_gen = timed(lambda: tango.generate(PROMPT, steps=STEPS, guidance=3.0, seed=0))
        wavs, t_batch = timed(lambda: tango.generate_for_batch(BATCH_PROMPTS, steps=STEPS,
                                                               batch_size=2, seed=0))
        if len(wavs) != len(BATCH_PROMPTS):
            raise AssertionError(f"{len(wavs)} waveforms for {len(BATCH_PROMPTS)} prompts")
        return [wav] + list(wavs), {"generate": t_gen, "generate_for_batch": t_batch}

    frames = tango.model.latent_t_size
    # 4x VAE, x160 vocoder, +32 samples of the vocoder's transposed-conv edge
    wav_len = lambda latent_t: latent_t * 4 * 160 + 32  # noqa: E731
    long_t = long_clip_frames(tango.model)
    remove = instrument(tango)
    by_path = {"serve": counted("serve", serve, wav_len(frames), phase="slice")}
    remove()

    # ---- a full-width reference-format snapshot of the same weights, written,
    # loaded by Tango(dir) (bf16, default tokenizer, cast_params=True), counted
    # as path `snapshot`, and run through the batch-generation CLI
    t_phase = time.perf_counter()
    snap_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_snapshot")
    shutil.rmtree(snap_root, ignore_errors=True)
    snap_dir = os.path.join(snap_root, "snapshot")
    written = write_snapshot(snap_dir, C, tango, random_encoder(C, seed=3))
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ts = Tango(snap_dir, device=DEVICE)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    params = compare_loaded(tango, ts)
    tokenizer_warned = any("WordHashTokenizer" in str(w.message) for w in caught)

    def snapshot_fields(launches):
        lat = (first_latents["snapshot"] - first_latents["serve"]).abs().max().item()
        wav = abs(first_wavs["serve"].astype("int32") - first_wavs["snapshot"].astype("int32"))
        return dict(**written, cold_start_s=round(cold_s, 3), dtype=str(ts.dtype),
                    tokenizer_warned=tokenizer_warned, params=params,
                    latents_max_abs_diff_vs_slice=lat, wav_max_int16_diff_vs_slice=int(wav.max()))

    remove = instrument(ts)
    by_path["snapshot"] = counted("snapshot", single(ts), wav_len(frames), extra=snapshot_fields)
    remove()
    lat_diff = (first_latents["snapshot"] - first_latents["serve"]).abs().max().item()
    if lat_diff != 0 or not tokenizer_warned:
        raise AssertionError(f"snapshot path: latents {lat_diff} from the slice's at the same "
                             f"seed (must be 0); tokenizer warning {tokenizer_warned}")
    del ts, remove  # the instruments' closures hold the pipeline
    torch.cuda.empty_cache()
    cli = cli_phase(os.path.join(snap_root, "cli"), snap_dir, wav_len(frames))
    torch.cuda.empty_cache()
    log("snapshot_cli", **cli, phase_s=round(time.perf_counter() - t_phase, 3),
        total_s=round(time.perf_counter() - t_start, 3))

    # ---- the entry points on the same snapshot, each counted: the HTTP
    # server, the SFT training CLI, the DPO training CLI
    t_phase = time.perf_counter()
    by_path["serve_http"] = serve_http_phase(snap_dir, counted, instrument, wav_len(frames))
    start = {k: v.detach().to("cpu", torch.float32) for k, v in tango.model.unet.state_dict().items()}
    manifest = write_wavs(os.path.join(snap_root, "data"), TRAIN_WAVS, 10.24, seed=0)
    mix_formats(manifest, ingest["libopus"])
    with open(manifest) as f:
        rows = f.readlines()
    with open(os.path.join(snap_root, "data", "val.json"), "w") as f:
        f.writelines(rows[:TRAIN_BATCH])
    for path, phase in (("train_cli", train_cli_phase), ("dpo", dpo_phase)):
        (path_launches, path_shapes, tc_launches[path],
         cluster_launches[path]) = phase(snap_dir, snap_root, start, ops)
        by_path[path] = (path_launches, path_shapes)
    del start
    (path_launches, path_shapes, tc_launches["tango2_eval"],
     cluster_launches["tango2_eval"]) = tango2_eval_phase(snap_dir, snap_root, ops)
    by_path["tango2_eval"] = (path_launches, path_shapes)
    torch.cuda.empty_cache()
    for path, (path_launches, path_shapes, tc_launches[path],
               cluster_launches[path]) in mesh_phase(C, ops, tango, snap_dir, snap_root).items():
        by_path[path] = (path_launches, path_shapes)
    log("mesh_done", total_s=round(time.perf_counter() - t_start, 3))
    shutil.rmtree(snap_root)
    torch.cuda.empty_cache()
    log("entry_points", phase_s=round(time.perf_counter() - t_phase, 3),
        total_s=round(time.perf_counter() - t_start, 3))

    # ---- Mustango, full width, written and loaded in the released layout
    # (only now: the Tango snapshot is gone from the disk), counted
    music_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "smoke_mustango")
    by_path["mustango"] = mustango_phase(C, ops, tango, counted, instrument, wav_len(frames),
                                         music_root)
    # the shapes only Mustango launched: the kernels phase checks and times
    # them with the rest
    log("mustango_done", total_s=round(time.perf_counter() - t_start, 3),
        new_shapes={n: len(v - set().union(*(p[1][n] for k, p in by_path.items()
                                              if k != "mustango")))
                    for n, v in by_path["mustango"][1].items()})

    # ---- AudioLDM, full width, from a monolithic checkpoint, counted
    by_path["audioldm"] = audioldm_phase(
        C, ops, counted, os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                      "smoke_audioldm"))
    log("audioldm_done", total_s=round(time.perf_counter() - t_start, 3))

    remove = instrument(tango)
    # one uncounted step at each new shape first: cuDNN's and cuBLAS's first use
    tango.generate("warm up", steps=1, duration=LONG_CLIP_S, seed=1)
    by_path["long_clip"] = counted("long_clip", single(tango, duration=LONG_CLIP_S),
                                   wav_len(long_t))
    tango.max_text_length = LONG_PROMPT_TOKENS
    tango.generate("warm up", steps=1, seed=1)
    by_path["long_prompt"] = counted("long_prompt", single(tango), wav_len(frames))
    tango.max_text_length = 128
    remove()

    # ---- the int8 W8A8 serving mode, on the same weights
    def quantized(scope, unet_params=None, cast_params=False):
        return Tango.from_components(
            unet_config=C.TANGO_UNET, vae_config=C.TANGO_VAE, t5_config=C.FLAN_T5_LARGE,
            hifigan_config=C.TANGO_HIFIGAN, scheduler_config=C.SD21_SCHEDULER, device=DEVICE,
            unet_params=tango.model.unet.state_dict() if unet_params is None else unet_params,
            vae_params=tango.vae.state_dict(), t5_params=tango.t5.state_dict(),
            hifigan_params=tango.vocoder.state_dict(), quant=scope, cast_params=cast_params)

    t0 = time.perf_counter()
    tq = quantized("all")
    tq.generate("warm up", steps=1, seed=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    def int8_fields(launches):
        ref, got = first_latents["serve"], first_latents["int8"]
        return dict(build_and_warmup_s=round(warm_s, 3),
                    w8a8_per_eval=launches["w8a8_matmul"] / STEPS,
                    rel_l2_vs_bf16=((got - ref).norm() / ref.norm()).item())

    remove = instrument(tq)
    by_path["int8"] = counted("int8", single(tq), wav_len(frames), extra=int8_fields)
    remove()
    tc = quantized("conv")
    remove = instrument(tc)
    conv_launches, _ = counted("int8_conv", single(tc, steps=2), wav_len(frames))
    remove()
    if conv_launches["w8a8_matmul"]:
        raise AssertionError(f"quant='conv' launched w8a8_matmul {conv_launches['w8a8_matmul']}"
                             " times")
    del tc, remove  # the instruments' closures hold the pipeline
    int8_order_phase(C, quantized)

    shapes = {n: set() for n in ops.all_kernels()}
    for _, path_shapes in by_path.values():
        for n, v in path_shapes.items():
            shapes[n] |= v

    # ---- launches in one UNet evaluation (CFG batch of one prompt), bf16 and
    # int8; the 3x3 stride-1 convolutions of the bf16 one, for winograd_conv3x3
    unet, m = tango.model.unet, tango.model
    lat = torch.randn(2, m.latent_t_size, m.latent_f_size, unet.cfg.in_channels, device=DEVICE)
    ctx = torch.randn(2, tango.max_text_length, unet.cfg.cross_attention_dim, device=DEVICE,
                      dtype=tango.dtype)
    mask = torch.ones(2, tango.max_text_length, dtype=torch.long, device=DEVICE)
    steps = torch.tensor([999, 999], device=DEVICE)

    def record(mod, inputs, _):
        x = inputs[0]
        if mod.stride == (1, 1) and mod.padding == (1, 1) and wino_supported(
                x.shape, mod.weight.shape, mod.stride):
            shapes["winograd_conv3x3"].add((tuple(x.shape), tuple(mod.weight.shape)))

    hooks = [mod.register_forward_hook(record) for mod in unet.modules()
             if isinstance(mod, torch.nn.Conv2d)]
    ops.reset_counters()
    with torch.inference_mode():
        unet(lat, steps, ctx, mask)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    per_eval = {n: fn.launches for n, fn in ops.KERNELS.items()}
    gemms = collections.Counter()  # (M, K, N) of the int8 evaluation's W8A8 GEMMs

    def record_gemm(mod, inputs, out):
        gemms[(math.prod(inputs[0].shape[:-1]), inputs[0].shape[-1], out.shape[-1])] += 1

    hooks = [mod.register_forward_hook(record_gemm) for mod in tq.model.unet.modules()
             if isinstance(mod, QLinear)]
    ops.reset_counters()
    with torch.inference_mode():
        tq.model.unet(lat, steps, ctx, mask)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    per_eval_int8 = {n: fn.launches for n, fn in ops.KERNELS.items()}
    w8a8_tc = ops.KERNELS["w8a8_matmul"].tc_launches
    n_qlinear = sum(isinstance(mod, QLinear) for mod in tq.model.unet.modules())
    # device time of one evaluation, bf16 and int8, and the int8 one's W8A8
    # kernels (quantize pass and GEMM)
    with torch.inference_mode():
        bf16_ms = device_ms(lambda: unet(lat, steps, ctx, mask), 3)
        int8_ms = device_ms(lambda: tq.model.unet(lat, steps, ctx, mask), 3)
    trace_phase(lambda: unet(lat, steps, ctx, mask), sum(per_eval.values()))
    log("per_eval", launches=per_eval, group_norms=per_eval["gn_silu_fwd"] + per_eval["gn_stats"],
        int8_launches=per_eval_int8, int8_w8a8_tc_launches=w8a8_tc, quantized_linears=n_qlinear,
        conv3x3_shapes=len(shapes["winograd_conv3x3"]),
        device_ms_per_eval={"bf16": sum(bf16_ms.values()), "int8": sum(int8_ms.values()),
                            "int8_w8a8": sum(t for k, t in int8_ms.items()
                                             if "w8a8" in k or "quantize_rows" in k)},
        w8a8_gemms_per_eval=[[*g, c] for g, c in sorted(gemms.items())])
    if "w8a8_matmul" in PATH_KERNELS["int8"] and not (
            per_eval_int8["w8a8_matmul"] == w8a8_tc == n_qlinear):
        raise AssertionError(f"{per_eval_int8['w8a8_matmul']} w8a8_matmul launches ({w8a8_tc} on "
                             f"the tensor-core body) in one int8 UNet evaluation for {n_qlinear} "
                             "quantized Linear layers")
    del tango, tq, unet, m
    torch.cuda.empty_cache()
    demo_phase(os.path.join(os.path.dirname(_build.build_info["path"]), "smoke_demo"))

    # ---- the training path, counted
    (train_launches, train_shapes, tc_launches["train"],
     cluster_launches["train"]) = train_phase(C, ops)
    by_path["train"] = (train_launches, train_shapes)
    launches = {n: sum(p[0][n] for p in by_path.values()) for n in ops.all_kernels()}
    for n, v in by_path["train"][1].items():
        shapes[n] |= v

    t0 = time.perf_counter()
    cases = check_kernels(ops, shapes, train_shapes, detail)
    log("kernels", seconds=round(time.perf_counter() - t0, 3),
        total_s=round(time.perf_counter() - t_start, 3),
        **{n: {"err_f32": c.err["f32"], "err_bf16": c.err["bf16"], "ms": c.ms,
               "plain_ms": c.plain_ms, "library_ms": c.library_ms, "bound_ms": c.bound,
               "f32": c.f32, **c.notes, "shapes": len(shapes[n])} for n, c in cases.items()})

    log("kernels_sp", **path_shape_times(cases, by_path["sp"][1]))
    log("kernels_sp_int8", **path_shape_times(cases, {"w8a8_matmul": by_path["sp_int8"][1][
        "w8a8_matmul"]}))
    log("kernels_sp_train", **path_shape_times(cases, by_path["sp_train"][1]))

    print(smi, flush=True)
    kernels = ops.all_kernels()
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": kernels[n].source,
         "replaces": kernels[n].replaces, "launches": launches[n],
         "launches_by_path": {p: v[0][n] for p, v in by_path.items()},
         "max_abs_err": max(c.err.values()), "ms": c.ms, "plain_ms": c.plain_ms,
         "bound_ms": c.bound, "bound_by": c.bound_by, "library_ms": c.library_ms,
         **tc_fields(kernels[n], {p: tc_launches.get(p, {}) for p in by_path},
                     {p: cluster_launches.get(p, {}) for p in by_path})}
        for n, c in cases.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
