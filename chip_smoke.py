"""Smoke run of the PyTorch/CUDA port (vegs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card
    python3 chip_smoke.py --quality-out QUALITY_TORCH.md   # and keep the
                                   # quality phase's readings in the report

Phases, one JSON line each; any failure exits non-zero:
  1. device   -- a CUDA card is present (prints nvidia-smi's name and power
                 limit);
  2. build    -- nvcc builds kernels K1 (blend forward), K2 (blend
                 backward), K3 (segment reduce), K4 (saturation count), M1
                 and M2 from vegs_torch/csrc, in parallel; ptxas registers
                 and shared memory per kernel, and the registers, shared
                 memory, resident blocks per SM and spills of K1, K2, K4
                 (16x16 tiles) and K3 as the CUDA runtime reports them,
                 and of K2's 16- and 32-warp builds (512- and 1024-pixel
                 tiles);
  3. k4_check -- K4 (the main path's entry, reading the payload rows
                 through the sorted Gaussian index) against its plain
                 PyTorch version on a saturating reduced scene (128x512,
                 60k Gaussians);
  4. k1_check -- K1 against its plain version at 128x512 with 30k Gaussians,
                 f32 and bf16 aux payloads;
  5. main     -- the serving path at full width: a seeded synthetic trained
                 field of 2,233,571 Gaussians (SH degree 3) written as a PLY,
                 loaded into a Scene with 3 street cameras at 376x1408,
                 capacities sized by a probe (no instance dropped), and
                 `render_frames` over the four default trajectories (12
                 frames) with the launch counters reset just before; then
                 the sat cull on vs off must give bit-identical rgb, depth
                 and alpha, and K1/K4 are held against their plain versions
                 on that frame's inputs; then K1 with its per-warp
                 footprint cull against K1 with the cull compiled out on
                 that frame (k1_cull): out and stop equal to the bit, both
                 times, the share of warp-instance pairs the cull skipped;
                 the same for K4 (k4_cull: counts equal); and K4 on the
                 payload rows where they lie against K4 on the JAX layout
                 (k4_gather: counts equal; the old path -- the prepass
                 gather, then K4 channel-major -- and the new one timed in
                 turns);
  6. timing   -- ms per frame, K1/K4 ms at the full-width shapes (CUDA
                 events), the plain versions' ms, the bound of each kernel,
                 peak device memory; then a profile of 4 frames;
  7. train    -- the training path at full width on the same field: ground
                 truth rendered from it on the 3 cameras, sh_dc perturbed by
                 +0.35, a synthetic unit normal map (normal loss on), and 8
                 steps of `Trainer.train_iteration` (iterations 3001-3008,
                 SH degree 3, bf16 aux, sat cull on, one densify-and-prune
                 event at the end of 3008), with the launch counters reset
                 just before; loss per step, ms per step, the densify step's
                 time, peak memory, launches (each kernel once per step),
                 then capacities re-probed for the densified field and a
                 profile of 2 more steps on it;
  8. k2/k3/k4 -- on the first step's full-width inputs: K4 with and
                 without its cull (k4_cull); K2 against its plain version
                 with card, plain and bound times; K2 with and without its
                 cull (k2_cull: dpf and dpa equal to the bit, both times,
                 the skipped share); K2's and the float32 plain version's
                 f32 rows on the deep instances of the 32 deepest tiles
                 against a float64 walk of those tiles (k2_f64); K3 as the
                 main path runs it, the gather's whole backward, against
                 its plain version (k3_fused: card, plain and bound times,
                 the library time -- autograd's own backward of the
                 gather, `k3_library`, held at K3's limit -- and the
                 earlier `index_add_` yardstick's (index_add_ms), the
                 segments' span distribution, the gather's backward's
                 device time fused and by the columns path); and K3 in the JAX
                 contract on those columns (k3_check, with the library
                 time);
  9. grad     -- one step's gradients (every field leaf, the means2d tap,
                 and every leaf of two box fields of different capacities
                 and of their residuals) through the kernels on the card
                 against the plain versions on the CPU, on a reduced scene
                 (128x512, 50k Gaussians and 2 boxes, bf16 aux);
  9b. tiles   -- wide tiles through the main path at 376x1408, K2's 16-
                 and 32-warp builds: one static Trainer step (iterations
                 3001-3003) on the train phase's field at each of 16x32,
                 32x16 and 32x32, capacities probed at that shape, each
                 step launching K1-K3 once and K4 once where its gate is
                 on (tiles_step); then, on bench.py's 500,000-Gaussian
                 scene (`vegs_torch.perf.refscale.build_scene`), k_cap
                 sized as perf/r05_tiles.py does, `rasterize`'s stages,
                 K1 and the loss mean(rgb^2) + 0.01 mean(depth^2), its
                 backward through K2 and K3, with the launch counters set
                 to 0 just before and read just after; K1 against its plain
                 version on every tile, K2's f32 and aux rows against the
                 plain K2 on the 32 deepest tiles and 32 seeded others
                 (the plain K2 walks each tile in Python) with phase 8's
                 limits and control, two K2 runs equal to the bit, K2's ms
                 and bound, K3 on K2's output with phase 8's limits and
                 control, K4's counts where its gate is on (tiles_check);
                 then `vegs_torch.perf.tiles`' sweep of 16x16, 16x32,
                 32x32 and 32x16 (tiles_sweep);
 10. boxes    -- the dynamic-scene training path at full width, after the
                 earlier phases' tensors are freed: the same seeded
                 2,233,571-Gaussian static field (a PLY) and 3 street
                 cameras, with 8 vehicle instances in every frame (car
                 boxes 4.2 x 1.6 x 1.8 at depths 8-36, yaws 0.3-1.2 rad,
                 each box's field built by `initialize_box_field` from
                 8,202 seeded mover points mapped to the world, written
                 as per-instance PLYs and loaded by `Scene`); each box's
                 share of each frame (>= 0.5%); the normal-prior init
                 (`Trainer.init_from_normals`, ms and count) on the
                 cameras' synthetic normal maps; capacities re-probed
                 with the boxes; ground truth by `render_all` at the
                 annotated poses, then sh_dc + 0.35 on every field and
                 each (frame, instance) residual's delta_t a seeded 0.05
                 off; 8 steps (iterations 3001-3008, one densify at 3008
                 over the field and every box) with the launch counters
                 reset just before -- loss, ms per step, the densify
                 step's ms, peak memory, K1-K4 launches (8 each), the mean
                 |delta_t| before and after, box rows and capacities
                 before and after; a profile of 2 more steps
                 (boxes_profile); then `render_all` ms per frame on the
                 3 frames, and K1 and K4 against their plain versions on
                 the first frame's inputs (limits of phases 3-5);
 11. cli      -- the training CLI from a KITTI-360 segment on disk, after
                 the boxes phase's tensors are freed: a synthetic segment
                 written under a temporary directory (2013_05_28_drive_0009
                 frames 3972-3979, stereo 376x1408 with the reference's
                 P_rect, camera 0 on the street cameras; a LiDAR PLY of the
                 seeded field's first 2,133,571 means and DC colours plus
                 200,000 hidden points, the COLMAP PLY of its other
                 100,000; the boxes phase's 8 vehicles as dynamic points
                 and an XML of 8 objects x 8 frames; 16 PNG frames rendered
                 by `render_all` and written with PIL; 16 synthetic normal
                 maps); the frames read back through the loader's
                 `_load_image` equal to the bit, and its ms (cli_png);
                 a probe that reads the segment through the loaders (the
                 readers', knn's and Scene's seconds), runs the normal
                 init and sizes --k_cap by the largest need + 25%
                 (cli_probe); then `vegs_torch.train.main` run A (24
                 iterations, densify at 16 and 24, a checkpoint at 12, a
                 report at 24) and run B (the same with
                 --start_checkpoint 12), each with the launch counters
                 reset just before: K1-K4 in every step, K2 and K3 exactly
                 once, each step's frame read from its PNG once, finite
                 losses, run B's restored state equal to the checkpoint
                 to the bit, the final PLYs (static and 8 instances)
                 loaded back by `Scene(load_iteration=-1)` finite,
                 cfg_args.json loading; ms per step (synchronized, the
                 lazy PNG and npy read inside), the densify steps', the
                 load, init, report and checkpoint times and sizes
                 (cli_run); the host's ms to read a frame and its normal
                 map (cli_frame_read); the launches of both runs (cli);
 12. tools    -- the offline tools around a training run, on the cli
                 phase's segment and trained model directory, after its
                 tensors are freed: the DPT normal estimator at its
                 published width (ViT-B/16 on an R50 stem, 384x384,
                 readout "project", random weights from seed 0) over the
                 segment's 16 frames in sliding mode (7 crops a frame),
                 the written maps read back through the KITTI-360 reader
                 with unit norm, one crop on the card against the CPU with
                 its control (tools_normals); 16 LoRA crops at 512 cut by
                 `lora_preprocess`, then `lora_train.train_segment` with
                 SD-2.1's UNet (LoRA rank 4) and VAE at full width, 3
                 steps x grad-accum 4, the saved lora_weights.pkl loaded
                 into a fresh UNet equal to the trained leaves to the bit
                 (tools_lora); `render_video.render_sets` at the last
                 iteration with interpolated cameras and box poses, 4
                 trajectories x 8 frames, capacities from a probe of those
                 views, the launch counters set to 0 just before (K1 and
                 K4 at least once a frame, nothing dropped), each mp4 read
                 back with OpenCV at 8 frames (tools_video); the test
                 cameras rendered with their boxes into
                 test/ours_<it>/{renders,gt} and `metrics.evaluate` on the
                 card, every view's SSIM and PSNR equal to the CPU's on
                 the same PNGs within 1e-5 (tools_metrics); PyTorch's
                 default TF32 settings for the timed DPT and LoRA runs,
                 TF32 off for the checks;
 13. guide    -- the diffusion-guided training step at full width, after
                 the tools phase's tensors are freed: the seeded
                 2,233,571-Gaussian field and 3 street cameras at 376x1408
                 as in the train phase (ground truth from the field, sh_dc
                 + 0.35, synthetic normal maps); SD-2.1-base's UNet (LoRA
                 rank 4, fresh) and the SD VAE at their published widths,
                 random weights from seed 0, random text embeddings [2, 77,
                 1024]; VGG16's features, random (the perceptual term on);
                 `sd_image_size` 512 (augmented views 512x1917); capacities
                 from a probe over the training views and the augmented
                 views the steps will draw (the Trainer's rng replayed on a
                 copy), need + 5% (guide_setup); 8 score-matching steps
                 (3001-3008), then 4 SDS steps (3009-3012), with PyTorch's
                 default TF32 settings, the launch counters reset just
                 before: K1-K4 exactly twice a step (the main and the
                 augmented render; M1 and M2 counted too), finite losses (guidance and perceptual
                 too), no instance dropped in either render, ms per step
                 by mode, the augmented views' raw and padded need, peak
                 memory (guide); a profile of 2 more SDS steps with the
                 device ms by scope -- the augmented render, the VAE
                 encoder, the UNet's CFG forward, VGG16, each forward and
                 backward (guide_profile); the SDS loss of one more
                 augmented crop alone, its gradient with respect to the
                 field finite, non-zero on some rows and zero on every row
                 the augmented view does not see (guide_grad_alone); K4
                 and K1 against their plain versions on that 512x1917
                 view, and K2 and K3 on the backward of that view's
                 guidance loss (aug_kernel_inputs), held as in phase 8;
                 then one guided SDS step's gradients through the kernels
                 on the card against the plain versions on the CPU
                 (128x512, 50k Gaussians, `sd_image_size` 64, the tiny
                 diffusion stack carried across with `convert`, the draws
                 replayed, TF32 off; f32 and bf16 aux), with the control
                 the card's CFG orientation flipped, and VGG16's
                 perceptual loss and image gradient on the card against
                 the CPU, with the control its last feature layer left
                 out (guide_grad_check);
 14. parallel -- multi-device training at full width, after the guide
                 phase's tensors are freed: the seeded 2,233,571-Gaussian
                 field and 3 street cameras at 376x1408 (ground truth from
                 the field, sh_dc + 0.35, synthetic normal maps, bf16 aux).
                 D = 1 under NCCL in this process (a world of one over a
                 file:// store): 3 single-device Trainer steps (3001-3003,
                 twice: the second run is the card's run-to-run floor),
                 3 `Trainer(dp_devices=1)` steps, the gauss- and
                 tile-sharded renders of camera 0 (the JAX tile-sharded
                 function raises at D = 1) and 3 `make_tp_train_step`
                 steps (parallel_d1: Adam's first moments against the
                 single-device Trainer's, relative L2 per leaf, with the
                 control the single-device moments two steps earlier; the
                 renders equal to the main path's render to the bit; ms
                 per step, peak memory, launches); then D = 2 as two
                 spawned gloo ranks sharing the card, "gloo-host" (every
                 collective staged through the host; NCCL refuses two ranks
                 on one card), each holding half of the field's 2,236,416
                 rows: the sharded renders equal to the bit, the
                 exchange's bucket sizes from a probe and k_exch sized by
                 its need + 5%, K1 and K2 held against their plain
                 versions on rank 0's layout of the first TP step (its
                 received splats on the full tile grid, only its own tiles
                 non-empty) and K3 on its `order_raw` stream, with the
                 limits and controls of phases 4 and 8 (parallel_kernels);
                 3 TP steps, their moments against D = 1's row block; 3
                 DP Trainer steps on 2 cameras, the replicated field, Adam
                 state and statistics' checksum equal on both ranks
                 (parallel_d2: ms per step, peak memory per rank beside
                 `sharded_state_bytes`, launches; parallel: the phase's
                 launches, each of K1-K4 at least once, K4 in the DP
                 steps). A D = 2 reading on one card measures the sharded
                 code, not scaling across cards;
 15. quality  -- the end-to-end quality run, after the parallel phase's
                 tensors are freed: arm A of `vegs_torch.perf.quality`
                 (the ray-traced street oracle at 128x256, 17 cameras,
                 the mover stripped, 1,500 iterations of the Trainer with
                 densify [100, 900] at tau 0.0002 and k_cap 2^17 free to
                 adapt), with every launch counter set to 0 just before:
                 the held-out PSNR and SSIM trend (every 300 iterations),
                 ms per step (median), wall s, k_cap's path, launches (K1,
                 K2, K3 at least once a step, K4 while its gate is on, M1
                 and M2 none); the final PSNR within the band
                 (`quality.PSNR_BAND_DB`, from the spread of three seeds)
                 of the JAX package's 28.40 dB, the SSIM within 0.02 of
                 0.903 (quality); K1, K2 and K3 (and K4 when its gate is
                 on) against their plain versions on the inputs of one
                 more step of the trained Trainer -- the densified field
                 at its adapted capacity -- with phase 8's limits and
                 controls (quality_kernels); then two controls, the same
                 run read at iteration 900 against the band around JAX's
                 it900 reading 27.04 dB (quality_control): SSIM's
                 depthwise filter in bf16 (input and window cast) with
                 the variance clamp kept, reported (an H100 read 25.99,
                 1.05 dB off: the clamp repairs most of the fault), and
                 the JAX package's SSIM before its round-5 fix -- the
                 filter in bf16 and the variances unclamped -- which must
                 miss (an H100 read 6.67 dB, as JAX's static arm read 6.5
                 before its fix); the phase's seconds (quality_phase).
                 With --quality-out PATH its readings also go into that
                 quality report;
 16. tp_quality -- the fully sharded trainer's quality runs
                 (`vegs_torch.perf.quality_tp`), shortened, after the
                 quality phase's tensors are freed: D = 4 ranks spawned
                 as gloo-host ranks sharing the card, the ray-traced
                 street oracle with its mover at 32x64 (9 cameras, 1,408
                 seeded points in 1,536 rows, the box field's 96 in 128,
                 every per-Gaussian tensor sharded, the box residuals
                 replicated), launch counters counted over the TP steps
                 alone in each rank (a spawned rank starts at 0). First
                 r05b's adapter demo, shortened: k_cap 1024 (floor 512,
                 decay window 25), a stale 32768 swapped in at it 60, 110
                 iterations; the adapter must grow, take the stale cap,
                 then decay, in that order, with no drop after its last
                 grow, and every rank must rebuild at the same iterations
                 (tp_quality_adapter). Then r05's seed-0 TP run to its
                 first densify event (it 160: k_cap 2^15 with the live
                 adapter, floor 512, window 30, which may only decay),
                 the mask report there -- `densify_masks` on the state
                 gathered in rank order against each rank's own -- with 0
                 rows differing (tp_quality_masks); then K1-K3 against
                 their plain versions on the inputs of one more step on
                 ranks 0 and 1 (at 32x64 the grid's two tile rows; ranks
                 2 and 3 own its padding), with phase 8's limits and
                 controls; K2's control, the deep instances off by 1%,
                 is held on the rank whose tiles hold more than 256
                 instances (rank 0's, the sky row, hold at most 256)
                 (tp_quality_kernels); each rank's TP steps launch K1-K3
                 and no K4 (the sharded paths run no sat cull), M1 or M2
                 (tp_quality). Readings about equivalence, not speed;
 17. perf     -- the measurement path (`vegs_torch.perf`), after the
                 tp_quality phase's tensors are freed: M1 (block sum) and M2
                 (transpose) against their plain versions at the probes'
                 full size (K = 2^21, f32 [K, 8] and bf16 [K, 16]; M1 in
                 both layouts), with card, plain, library times and
                 bounds (m1_check, m2_check); then, with every launch
                 counter set to 0, the eight layout probes (micro3), the
                 stage split at 2,233,571 Gaussians, 376x1408, 16x16
                 tiles, sat cull on (refscale), and each stage's bound and
                 share of its time (roofline); every kernel must have
                 launched in this path;
 17b. probes -- the main path's probes at bench shape, with every launch
                 counter set to 0 just before: the stage split at 500,000
                 Gaussians, 16x16 tiles, k_cap 1,126,912, each stage's
                 bound (stages), and stages_r02's bisect forward and
                 forward+backward (`vegs_torch.perf.stages`); r06's, r08's
                 and r11's binning and row-gather A/Bs, r06's delta map
                 held equal to the bit to the current map and r11's
                 scatter-and-cumsum to the gather it would replace
                 (binning_probes); the sat-cull potential at 2,233,571
                 Gaussians beside K4's and K1's prune on the same frame
                 (satcull_analysis); r12's debug trail at 64x128 and
                 128x256, cut to DEBUG_ITERS iterations each, and r12b's
                 gradient statistics at both sizes (quality_debug); each
                 line with the card; K1-K3 launched (probes);
 17c. micro -- the remaining perf scripts at their bench shapes, with every
                 launch counter set to 0 just before: the glue
                 micro-probes of micro_r02 (14), micro2_r02 (8), r03_micro
                 (11) and r03_micro2 (6) at K = 2^21, N = 500,000
                 (`vegs_torch.perf.micro`); the gather backward's pieces
                 of r04_gebwd, r05_gebwd2, r05_segreduce and
                 r05_segreduce2 (`gebwd`: K3 as the main path runs it and
                 under the JAX contract); r03_bwd_bisect at 500k, k_cap
                 2^21 (`stages.bwd_bisect`, every loss and gradient
                 finite); r07_shard_pallas at 200k (`shard_check`: the
                 D = 1 tile-sharded render under NCCL equal to
                 `rasterize` to the bit, f32 and bf16, fwd+bwd of both, the
                 fully sharded trainer's step at 50k); each line timed in
                 PROBE_ITERS windows; K1-K3 and K3's JAX-contract entry
                 launched, M1 and M2 not. Then K3 under the JAX contract
                 at r05_segreduce2's shape (500,224 segments, the last 223
                 empty) against `segment_reduce_ref` with phase 8's limit
                 and control, the empty segments 0, card, plain, library
                 and bound times (k3_contract_bench), and K3 as the main
                 path runs it on r05_segreduce's permuted order and padded
                 ends, with phase 8's limits and controls (k3_fused_r05);
 17d. legacy_quality -- r03 of `vegs_torch.perf.quality` in full
                 (64x128, 17 cameras, 1,000 iterations: the mover with
                 0.08 m of noise, normal init, the perceptual term, the
                 tiny SD guiding in [750, 1000]), every launch counter set
                 to 0 just before: its final held-out PSNR at or above the
                 JAX package's 11.92 dB less `quality.PSNR_BAND_DB` (a
                 one-sided limit: the port carries the fixes that JAX's
                 run predates) and within that band of the port's own
                 card reading (`quality.PORT_R03_FINAL`, 28.20 dB), its
                 untrained reading at iteration 0 (the control) missing
                 both, K1-K3 in every step. With
                 --quality-out PATH its record also goes into that report;
 18. the kernels summary line (launches: the train phase's; launches_boxes:
     the boxes phase's; launches_cli: the cli phase's; launches_tools: the
     tools phase's `render_sets`; launches_guide: the guide phase's;
     launches_parallel: the parallel phase's, both D; launches_quality:
     the quality phase's arm A; launches_tp_quality: the tp_quality
     phase's TP steps, every rank; launches_tiles: the tiles phase's;
     launches_probes: the probes phase's; launches_micro: the micro
     phase's (K3's JAX-contract entry under its jax_contract, beside its
     bench-shape readings); launches_legacy_quality: r03's; K2's row also
     has its readings,
     ms and bound at each wide tile shape under "tiles"), then
     the card line, then the last line
     {"ok": true, "device": {...}}.

Tolerances: K4 counts must agree (a tile may differ only by exactly one
256-slot window, and is reported; the bit-identical sat-cull render is the
binding check). K1 against its plain version: |d| <= 1e-5 + 1e-4 * |ref| on
every channel outside pixels whose stop index differs, and those at most
0.1% of the pixels -- the plain version prefix-sums log(1 - alpha) with a
parallel scan and accumulates the channels with a matmul, the kernel walks
each pixel sequentially with FMAs, so the sums differ in order only.

K2, K3 and the step gradients are each held by a limit set from the
readings of a sound run on an H100, and each check also reads a control --
a deliberately wrong result -- which must fall outside the limit (readings
and controls in PERF.md). K4 with the cull against K4 without it, and on
the payload rows against the JAX layout: equal counts. K2, on the instances
of tiles whose pixels all stop where the plain forward stops (such flip
tiles at most 1%): |d| <= 1e-4 of the largest |plain| of the f32 row, and
of the aux row within the instance's group (its tile's 256-instance batch),
plus one bf16 ulp (2^-7 |ref|) on bf16 rows; control: the kernel's output
1% off on the instances after each tile's first 256. K3: |d| <= 1e-5 * (sum
of |x| over the segment) -- the plain version adds with atomics in any
order on the card; on the fused entry's aux rows, plus one bf16 ulp of
|ref| (both round their float32 sums once); control: each segment's last
column left out. Step gradients: relative L2 error <= 1e-4 per leaf; a
box's colour leaves are one bf16 K3 aux row a Gaussian times SH constants,
so the plain run takes the card's row value where the two are exactly one
bf16 step apart, and at most 1% of those values may be; control: K2's f32
rows rounded to bf16, and K3's box colour rows one bf16 step toward
zero. K1 and K2 with the cull against the same kernels without it: equal
to the bit. K2's f32 rows on the deep
instances of the 32 deepest tiles against a float64 walk of those tiles
(the float64 forward seeding it): |d| <= 1e-2 of the largest |float64| of
the instance's 256-instance group -- the float32 cancellation of dL = tail
- cum is what is left there, and the kernel's compensated sums read 5.6e-3
on an H100 against the float32 plain version's 7.4e-3; control: the
kernel's output 1% off there (1.4e-2). M2 must be bit-identical to its
plain version. M1: |d| <= 1e-8 * (sum of |x|) -- the kernel and its plain
version add in other orders; the sound readings on an H100 are at most
1.3e-10; control: the sum with the last 2^17-long block left out. The
guided step's gradients, card against CPU: relative L2 error <= 1e-4 per
field leaf (the kernels against their plain versions, cuDNN's convolutions
against the CPU's) with f32 aux, <= 1e-3 with bf16 aux (one bf16 step on
every colour row reads 3.9e-3 or more); control: the card's CFG
orientation flipped. VGG16's image gradient, card against CPU: relative L2
error <= 1e-2 (a ReLU mask or a max-pool choice flips where two float32
runs differ in the last bits; the CPU parity tests read 1.0e-4 between JAX
and torch, an H100 read 1.16e-3); control: the card's loss without its
last feature layer. The tools phase: the DPT crop, card against CPU, both
float32: |d| of the unit normals, scaled by the length of the decoded
vector each normalizes where that is under 1, <= 1e-3 (an H100 read
5.7e-5); control: the card's readout projections with their cls-token
columns zeroed (1.7). The metrics' SSIM and PSNR, card against CPU on the
same PNGs: within 1e-5 relative (read: 1.5e-7). The LoRA file reloaded:
equal to the bit.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
H, W = 376, 1408
N_REF = 2_233_571            # the reference's recorded scene size
SEED = 0
PROBE_CAP = (1 << 23) - 512  # raw capacity of the sizing probe

# Each kernel's bound (vegs_torch/perf/roofline.py): the larger of the
# bytes its inputs and outputs move once at 3.35 TB/s and the fp32
# operations these inputs need at 67 TFLOP/s, counted with the plain
# versions' `pairs` record of this run.

K1_ATOL, K1_RTOL, MAX_FLIP_SHARE = 1e-5, 1e-4, 1e-3
K2_RTOL = 1e-4
# the scale each K2 row set is held by (see `k2_readings`): the f32 rows'
# low-T instances cancel in f32 (dL = tail - cum), in the kernel and the
# plain version alike, so they are held by the row's max
K2_SCALE = {"f32_rows": "row", "aux_rows": "group"}
BF16_ULP, K2_MAX_FLIP_TILES = 2.0 ** -7, 0.01
K3_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the share of the grad phase's box colour values that K3 rounds to the
# neighbouring bf16 value of the plain version's (see `k3_colour_rows`)
COLOUR_MAX_FLIP_SHARE = 0.01
CONTROL_ERR = 0.01  # the K2 control's error on the deep instances
M1_RTOL = 1e-8
K2_F64_TILES = 32   # the deepest tiles of the first step, walked in float64
K2_F64_RTOL = 0.01  # K2's deep f32 rows against float64, of the group max
# the grad phase's boxes: (Gaussians, capacity) each
GRAD_BOX_CAPS = ((3000, 4096), (5000, 8192))
CAR_SIZE = (4.2, 1.6, 1.8)  # a car's length, height (y is down), width, m
# the boxes phase: 8 vehicles (the default max_box_slots) of BOX_POINTS
# canonical points each, at these world depths, yaws and lateral places
# (a share of the half-width at their depth), in every one of the frames
BOX_INST0, BOX_POINTS = 26001, 8196
BOX_DEPTHS = (8.0, 12.0, 16.0, 20.0, 24.0, 28.0, 32.0, 36.0)
BOX_YAWS = (0.3, 1.1, 0.5, 0.9, 0.35, 1.2, 0.7, 0.45)
BOX_LATERAL = (-0.55, 0.45, -0.2, 0.25, -0.45, 0.55, 0.05, -0.6)
# the normal prior flattens the field into 0.1-unit discs, which need ~4-6x
# the raw instances of the trained field (the boxes line's `need_raw`)
BOX_PROBE_CAP = (1 << 25) - 512

# Iterations 3001-3008 (SH degree 3 active); the one densify-and-prune
# event falls at 3008, after that step's loss, so the losses compare the
# same field's training and the 2 profiled steps run on the densified field.
TRAIN_FIRST_IT, TRAIN_STEPS, DENSIFY_EVERY = 3001, 8, 8
TRAIN_CAMS = (0, 1, 2, 0, 1, 2, 1, 0)  # the last step sees the first's view


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def r512(v: float) -> int:
    return (int(v) + 511) // 512 * 512


def field_stage(field, cam, cfg, boxes=()):
    """`rasterize`'s stages before the blend of the field, and of the
    `boxes` (`BoxInstance`s) with it as `render_all` concatenates them."""
    from vegs_torch.ops.rasterize import stage
    from vegs_torch.render import _box_arrays, _concat_arrays, field_arrays

    a = _concat_arrays([field_arrays(field)]
                       + [_box_arrays(b, 3) for b in boxes])
    return stage(a.means, a.quats, a.scales, a.opacities, a.shs, cam,
                 valid=a.valid, config=cfg)


def k4_args(st):
    """The main path's K4 inputs of a `Staged`: the padded payload rows,
    the sorted Gaussian index, the raw ranges, the grid."""
    return st.pay_rows, st.rb.gidx_sorted, st.rb.raw_starts, st.grid


def compare_k4(st):
    """K4 (the main path's entry) vs its plain version on the same CUDA
    inputs."""
    from vegs_torch.ops import satcull

    args = k4_args(st)
    grid = st.grid
    k = satcull.satcount_gathered(*args)
    t0 = time.perf_counter()
    ref = satcull.satcount_gathered_ref(*args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    d = (k.long() - ref.long()).abs()
    bad = int(((d != 0) & (d != 256)).sum())
    if bad:
        raise AssertionError(f"K4: {bad} tiles differ from the plain version "
                             "by other than one 256-slot window")
    raw = int(st.rb.raw_starts[-1] - st.rb.raw_starts[0])
    return {"tiles": grid.num_tiles, "tiles_off_by_256": int((d == 256).sum()),
            "max_abs_err": int(d.max()), "kept": int(k.sum()), "raw": raw,
            "plain_ms": plain_s * 1e3}


def k4_cull(st) -> dict:
    """K4 with its per-warp footprint cull against K4 with the cull
    compiled out, on the main path's inputs: counts equal (torch.equal);
    both times; the warp-instance pairs considered, walked and the skipped
    share."""
    from vegs_torch.ops import satcull

    args = k4_args(st)
    on = satcull.satcount_check(*args, cull=True)
    off = satcull.satcount_check(*args, cull=False)
    res = {"equal": bool(torch.equal(on[0], off[0])),
           **cull_times(lambda c: satcull.satcount_check(*args, cull=c,
                                                         counts=False)),
           "pairs": on[1], "pairs_nocull": off[1]}
    if not res["equal"]:
        raise AssertionError(f"K4 with and without the cull differ: {res}")
    return res


def k4_gather(st) -> dict:
    """K4 reading the payload rows where they lie (the main path) against
    K4 on the JAX layout (pay_rows[gidx_sorted].T, channel-major): counts
    equal (torch.equal). Times by CUDA events, in turns old, new, new, old:
    the new path (K4 gathered) and the old one (the prepass gather, then K4
    channel-major), and each K4 alone."""
    from vegs_torch.ops import satcull
    from vegs_torch.perf.timing import cuda_ms

    pay, gidx, starts, grid = k4_args(st)

    def prepass():
        return pay[gidx.long()].T.contiguous()

    pf_cm = prepass()
    new = satcull.satcount_gathered(pay, gidx, starts, grid)
    old = satcull.satcount(pf_cm, starts, grid)
    equal = bool(torch.equal(new, old))
    runs = {"old_path": [], "new_path": [], "k4_cm": [], "prepass": []}
    for turn in ("old", "new", "new", "old"):
        if turn == "new":
            runs["new_path"].append(cuda_ms(
                lambda: satcull.satcount_gathered(pay, gidx, starts, grid)))
        else:
            runs["old_path"].append(cuda_ms(
                lambda: satcull.satcount(prepass(), starts, grid)))
            runs["k4_cm"].append(cuda_ms(
                lambda: satcull.satcount(pf_cm, starts, grid)))
            runs["prepass"].append(cuda_ms(prepass))
    res = {"equal": equal, "slots": int(gidx.shape[0]),
           **{f"{k}_ms": float(np.mean(v)) for k, v in runs.items()},
           "runs": runs}
    if not equal:
        raise AssertionError(f"K4 gathered and channel-major differ: {res}")
    return res


def compare_k1(st):
    """K1 vs blend_ref_tiles on the same CUDA inputs."""
    from vegs_torch.ops import blend_cuda

    grid = st.grid
    hp, wp = grid.padded_height, grid.padded_width
    args = (st.payload_f32, st.payload_aux, st.binned.tile_starts, grid, hp, wp)
    out, stop = blend_cuda.blend(*args, return_stop=True)
    t0 = time.perf_counter()
    ref, stop_ref = blend_cuda.blend_ref_tiles(*args, return_stop=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise AssertionError("K1 output is not finite")
    flips = stop != stop_ref
    d = (out - ref).abs()
    bad = (d > K1_ATOL + K1_RTOL * ref.abs()).any(dim=0) & ~flips
    n_flips = int(flips.sum())
    per_chan = d.masked_fill(flips[None], 0).amax(dim=(1, 2))
    res = {"pixels": hp * wp, "stop_flips": n_flips,
           "max_abs_err_per_channel": [float(x) for x in per_chan],
           "max_abs_err": float(per_chan.max()),
           "instances": int(st.binned.tile_starts[-1]),
           "plain_ms": plain_s * 1e3}
    if int(bad.sum()):
        raise AssertionError(f"K1: {int(bad.sum())} pixels outside tolerance "
                             f"without a stop flip: {res}")
    if n_flips > MAX_FLIP_SHARE * hp * wp:
        raise AssertionError(f"K1: {n_flips} stop-index flips: {res}")
    return res


KERNEL_GROUPS = (("K1 blend_fwd", ("blend_fwd_kernel",)),
                 ("K2 blend_bwd", ("blend_bwd_kernel",)),
                 ("K3 segreduce", ("segreduce_kernel", "rows_kernel")),
                 ("K4 satcount", ("satcount_kernel",)),
                 ("conv (SSIM)", ("conv", "Conv", "cudnn", "implicit_gemm")),
                 ("sort", ("sort", "Sort", "radix", "Radix")),
                 ("scan", ("scan", "Scan", "cumsum", "cummax")),
                 ("gather/scatter", ("index", "Index", "gather", "scatter")),
                 ("copy", ("Memcpy", "memcpy", "Memset", "memset")))


def profile_frames(fn, by_scope: bool = False) -> dict:
    """Device time by kernel group and the device's busy share of the wall
    time of `fn` (torch.profiler's CUDA kernel events); with `by_scope`,
    the device time by the guided step's scopes too (`scope_split`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, groups, by_name = [], {}, {}
    for e in prof.events():
        # (the GUIDE_SCOPES ranges also show on the device's timeline)
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name in GUIDE_SCOPES):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.name for k in keys)), "elementwise/other")
        groups[group] = groups.get(group, 0.0) + (end - start) / 1e3
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (end - start) / 1e3
    busy, last = 0.0, None
    for start, end in sorted(spans):  # union of kernel intervals
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": (1 - busy / wall_us) if spans else None,
           "kernels": len(spans), "ms_by_group": groups,
           "top_kernels_ms": dict(top)}
    if by_scope:
        res["ms_by_scope"] = scope_split(prof)
        res["ms_by_scope"]["kernels not linked to an op"] = (
            sum(groups.values()) - sum(res["ms_by_scope"].values()))
    return res


# the scopes of a guided step (`vegs_torch.train.guidance_loss`,
# `losses.sd_guidance`, `losses.perceptual`)
GUIDE_SCOPES = ("vegs::aug_render", "vegs::vae_encode", "vegs::unet_cfg",
                "vegs::vgg_perceptual")


def scope_split(prof, time_us=None) -> dict:
    """ms by scope of a profile: each op's own kernels (`time_us`, default
    their device time) go to the innermost GUIDE_SCOPES range around it in
    the forward, or, in the backward, to the range of the forward op whose
    autograd node it evaluates (the profiler's sequence numbers); all else
    to "rest of the step" (the main render, its loss and backward, Adam)."""
    if time_us is None:
        def time_us(e):
            return sum(k.duration for k in e.kernels
                       if k.name not in GUIDE_SCOPES)
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]

    def scope(e):
        while e is not None:
            if e.name in GUIDE_SCOPES:
                return e.name, "fwd"
            if (e.name.startswith("autograd::engine::evaluate_function")
                    and e.sequence_nr in forward):
                return forward[e.sequence_nr], "bwd"
            e = e.cpu_parent
        return None, None

    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            name, way = scope(e)
            if way == "fwd":
                forward.setdefault(e.sequence_nr, name)
    out = {}
    for e in cpu:
        us = time_us(e)
        if us:
            name, way = scope(e)
            key = f"{name} {way}" if name else "rest of the step"
            out[key] = out.get(key, 0.0) + us / 1e3
    return out


def slot_tiles(tile_starts, k, grid):
    """Per padded slot: its tile, and its 256-instance batch in the tile's
    range (slots past tile_starts[-1] fall in the last tile's tail)."""
    from vegs_torch.ops.binning import PAD_ALIGN

    ts = tile_starts.long()
    slot = torch.arange(k, device=ts.device)
    tile = torch.searchsorted(ts[1:], slot, right=True).clamp(
        max=grid.num_tiles - 1)
    return tile, (slot - ts[tile]) // PAD_ALIGN


def deep_control(tile_starts, k, grid):
    """[k] f32 factors of the control: 1 + CONTROL_ERR on every instance
    after its tile's first 256 (the deep, low-T instances), 1 elsewhere --
    an error a wrong kernel could make there and nowhere else."""
    _, batch = slot_tiles(tile_starts, k, grid)
    return 1.0 + CONTROL_ERR * (batch > 0).float()


def staged_loss(field, tap, cam, gt, normal, sh_degree, bg, opt_cfg,
                raster_cfg, boxes=(), lambda_reg=0.0):
    """The training step's loss (`train.loss_fn`, with the `boxes`' parts
    and pull when there are any) from the stages that `rasterize` runs on
    the kernel path, called one by one -- `stage`, the blend (`BlendFn`:
    K1, and K2 in the backward), `raster_out`, `image_loss` -- so that the
    blend's payload and padded output are at hand. Returns (loss, Staged,
    padded output)."""
    from vegs_torch import boxmodel
    from vegs_torch.ops.blend_cuda import BlendFn
    from vegs_torch.ops.rasterize import raster_out, stage
    from vegs_torch.render import _box_arrays, _concat_arrays, field_arrays
    from vegs_torch.train import image_loss

    a = _concat_arrays([field_arrays(field, sh_degree)]
                       + [_box_arrays(b, sh_degree) for b in boxes])
    st = stage(a.means, a.quats, a.scales, a.opacities, a.shs, cam,
               sh_degree=3, valid=a.valid, means2d_offset=tap,
               config=raster_cfg)
    g = st.grid
    out_p = BlendFn.apply(st.payload_f32, st.payload_aux,
                          st.binned.tile_starts, g, g.padded_height,
                          g.padded_width)
    ro = raster_out(st, out_p[:, :cam.height, :cam.width], bg)
    loss = image_loss(ro, gt, normal, 1.0, opt_cfg)[0]
    if boxes:
        loss = loss + lambda_reg * torch.stack(
            [boxmodel.regularize_loss(b.deltas) for b in boxes]).sum()
    return loss, st, out_p


def step_kernel_inputs(trainer, cam, it, dev, need_sat=True):
    """K2's, K3's and K4's inputs of the step `trainer` would take next on
    `cam`: the same loss, its gradient at the blend's padded output (K2's
    dout), K3's cotangents from K2's output on them (no Adam update), and
    K4's inputs (`k4_args` of the `Staged`; with `need_sat`, the sat cull
    must be on at the trainer's capacity). Returns (K2 args, K3 args, the
    `Staged`, the loss)."""
    from vegs_torch.ops import blend_cuda

    field = trainer.state.field
    tap = torch.zeros((field.capacity, 2), device=dev, requires_grad=True)
    gt = torch.from_numpy(np.asarray(cam.original_image, np.float32)).to(dev)
    normal = torch.from_numpy(np.asarray(cam.world_normal(), np.float32)
                              ).to(dev)
    loss, st, out_p = staged_loss(
        field, tap, cam.device_params(dev), gt, normal,
        trainer._active_sh_degree(it), trainer.bg, trainer.cfg.opt,
        trainer.raster_cfg)
    if need_sat and st.sat_counts is None:
        raise AssertionError("the training step should run the sat cull")
    (dout,) = torch.autograd.grad(loss, out_p)
    k2_args = (st.payload_f32.detach(), st.payload_aux.detach(),
               st.binned.tile_starts, out_p.detach(), dout.contiguous(),
               st.grid)
    dpf, dpa = blend_cuda.blend_bwd(*k2_args)
    # the segment ends as `stage` gives them to the gather (the dummy row n
    # gets an empty segment)
    ends = torch.cat([st.binned.gauss_ends, st.binned.gauss_ends[-1:]])
    k3_args = (dpf, dpa, st.binned.order, ends)
    torch.cuda.synchronize()
    return k2_args, k3_args, st, float(loss.detach())


def aug_kernel_inputs(field, guided, iteration, sh_degree, bg, raster_cfg):
    """K2's and K3's inputs of a guided step's augmented render: the static
    field staged at the augmented camera without a means2d tap, blended and
    cropped as `train.guidance_loss` does, the guidance loss of the crop at
    `iteration`, its gradient at the blend's padded output (K2's dout), and
    K3's cotangents from K2's output on them. Returns (K2 args, K3 args,
    the `Staged`)."""
    from vegs_torch.ops import blend_cuda
    from vegs_torch.ops.blend_cuda import BlendFn
    from vegs_torch.ops.rasterize import raster_out, stage
    from vegs_torch.render import field_arrays

    a = field_arrays(field, sh_degree)
    cam = guided.cam
    st = stage(a.means, a.quats, a.scales, a.opacities, a.shs, cam,
               sh_degree=3, valid=a.valid, means2d_offset=None,
               config=raster_cfg)
    if st.sat_counts is None:
        raise AssertionError("the augmented render should run the sat cull")
    g = st.grid
    out_p = BlendFn.apply(st.payload_f32, st.payload_aux,
                          st.binned.tile_starts, g, g.padded_height,
                          g.padded_width)
    rgb = raster_out(st, out_p[:, :cam.height, :cam.width], bg).rgb
    h, w = rgb.shape[1:]
    s = min(max(int(guided.crop_start), 0), w - h)
    loss = guided.guidance(rgb[:, :, s:s + h], iteration,
                           generator=guided.generator)
    (dout,) = torch.autograd.grad(loss, out_p)
    k2_args = (st.payload_f32.detach(), st.payload_aux.detach(),
               st.binned.tile_starts, out_p.detach(), dout.contiguous(), g)
    dpf, dpa = blend_cuda.blend_bwd(*k2_args)
    ends = torch.cat([st.binned.gauss_ends, st.binned.gauss_ends[-1:]])
    k3_args = (dpf, dpa, st.binned.order, ends)
    torch.cuda.synchronize()
    return k2_args, k3_args, st


def k2_readings(kern, ref, tile_starts, grid, keep, ulp):
    """The largest |kernel - plain| (less one bf16 ulp of the plain value on
    bf16 rows), on the slots in `keep` (tiles without a stop flip), over
    two scales of each gradient row: the row's largest |plain| ("row"), and
    the largest |plain| of the instance's group, the 256-instance batch of
    its tile in which it is staged ("group"; a group whose plain gradients
    are all zero reads inf unless the kernel's are zero too)."""
    tile, batch = slot_tiles(tile_starts, kern.shape[1], grid)
    group = torch.unique(tile * (batch.max() + 1) + batch,
                         return_inverse=True)[1]
    ng = int(group.max()) + 1
    d = ((kern - ref).abs() - ulp * ref.abs()).clamp(min=0)
    d = torch.where(keep[None, :], d, torch.zeros((), device=d.device))
    idx = group[None, :].expand(ref.shape[0], -1)
    gref = ref.new_zeros(ref.shape[0], ng).scatter_reduce_(
        1, idx, ref.abs(), "amax")
    gd = ref.new_zeros(ref.shape[0], ng).scatter_reduce_(1, idx, d, "amax")
    inf = torch.tensor(float("inf"), device=d.device)
    by_group = torch.where(gref > 0, gd / gref.clamp(min=1e-30),
                           torch.where(gd > 0, inf, torch.zeros_like(gd)))
    by_row = d.amax(dim=1) / ref.abs().amax(dim=1).clamp(min=1e-30)
    return {"row": float(by_row.max()), "group": float(by_group.max())}


def compare_k2(k2_args):
    """K2 vs blend_bwd_ref_tiles on the same CUDA inputs, outside the tiles
    where K1 and its plain version stop at different instances: the
    readings (`k2_readings`) of the sound kernel and of the control, the
    kernel's output off by CONTROL_ERR on the deep instances
    (`deep_control`)."""
    from vegs_torch.ops import blend_cuda

    pf, pa, ts, out, dout, grid = k2_args
    hp, wp = grid.padded_height, grid.padded_width
    _, stop = blend_cuda.blend(pf, pa, ts, grid, hp, wp, return_stop=True)
    pairs = {}
    _, stop_ref = blend_cuda.blend_ref_tiles(pf, pa, ts, grid, hp, wp,
                                             return_stop=True, pairs=pairs)
    kpf, kpa = blend_cuda.blend_bwd(*k2_args)
    t0 = time.perf_counter()
    rpf, rpa = blend_cuda.blend_bwd_ref_tiles(*k2_args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for x in (kpf, kpa, rpf, rpa):
        if not torch.isfinite(x).all():
            raise AssertionError("K2 or its plain version is not finite")
    flips = (stop != stop_ref).reshape(grid.nty, grid.tile_h, grid.ntx,
                                       grid.tile_w).any(dim=3).any(dim=1)
    tile, batch = slot_tiles(ts, pf.shape[1], grid)
    keep = ~flips.reshape(-1)[tile]
    ctl = deep_control(ts, pf.shape[1], grid)
    bf16_ulp = BF16_ULP if pa.dtype == torch.bfloat16 else 0.0
    res = {"tiles": grid.num_tiles, "flip_tiles": int(flips.sum()),
           "instances": int(ts[-1]),
           "deep_instances": int((batch > 0)[:int(ts[-1])].sum()),
           "nonzero_dop": int((kpf[5] != 0).sum()), "plain_ms": plain_s * 1e3,
           "pairs": pairs}
    for rows, k, r, ulp in (("f32_rows", kpf, rpf, 0.0),
                            ("aux_rows", kpa, rpa.float(), bf16_ulp)):
        k_ctl = (k.float() * ctl).to(k.dtype).float()
        res[rows] = {
            "reading": k2_readings(k.float(), r, ts, grid, keep, ulp),
            "control_reading": k2_readings(k_ctl, r, ts, grid, keep, ulp)}
    res["max_abs_err"] = float(max(
        (kpf - rpf)[:, keep].abs().max(),
        (kpa.float() - rpa.float())[:, keep].abs().max()))
    return res


def hold(name, reading, limit, control=None):
    """Fail unless the sound reading is within `limit` and the control
    reading (of a deliberately wrong result) is outside it."""
    if not reading <= limit:
        raise AssertionError(f"{name}: reading {reading} over the limit "
                             f"{limit}")
    if control is not None and not control > limit:
        raise AssertionError(f"{name}: the control reads {control}, within "
                             f"the limit {limit}: the check is too loose")


def bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def cull_times(fn) -> dict:
    """ms per call of fn(True) (the kernel with its cull) and fn(False)
    (compiled out), by CUDA events, in turns off, on, on, off."""
    from vegs_torch.perf.timing import cuda_ms

    t = {True: [], False: []}
    for cull in (False, True, True, False):
        t[cull].append(cuda_ms(lambda: fn(cull)))
    return {"ms": float(np.mean(t[True])), "ms_nocull": float(np.mean(t[False])),
            "ms_runs": t[True], "ms_nocull_runs": t[False]}


def k1_cull(st) -> dict:
    """K1 with its per-warp footprint cull against K1 with the cull
    compiled out, on the same inputs: out and stop equal to the bit; both
    times; the warp-instance pairs considered, walked and the skipped
    share."""
    from vegs_torch.ops import blend_cuda

    g = st.grid
    args = (st.payload_f32, st.payload_aux, st.binned.tile_starts, g,
            g.padded_height, g.padded_width)
    on = blend_cuda.blend_check(*args, cull=True)
    off = blend_cuda.blend_check(*args, cull=False)
    res = {"bit_identical": {"out": bool(torch.equal(bits(on[0]), bits(off[0]))),
                             "stop": bool(torch.equal(on[1], off[1]))},
           **cull_times(lambda c: blend_cuda.blend_check(*args, cull=c,
                                                         counts=False)),
           "pairs": on[2], "pairs_nocull": off[2]}
    if not all(res["bit_identical"].values()):
        raise AssertionError(f"K1 with and without the cull differ: {res}")
    return res


def k2_cull(k2_args) -> dict:
    """K2 with and without its cull, as `k1_cull`: dpf and dpa equal to
    the bit."""
    from vegs_torch.ops import blend_cuda

    on = blend_cuda.blend_bwd_check(*k2_args, cull=True)
    off = blend_cuda.blend_bwd_check(*k2_args, cull=False)
    res = {"bit_identical": {"dpf": bool(torch.equal(bits(on[0]), bits(off[0]))),
                             "dpa": bool(torch.equal(bits(on[1]), bits(off[1])))},
           **cull_times(lambda c: blend_cuda.blend_bwd_check(
               *k2_args, cull=c, counts=False)),
           "pairs": on[2], "pairs_nocull": off[2]}
    if not all(res["bit_identical"].values()):
        raise AssertionError(f"K2 with and without the cull differ: {res}")
    return res


def k2_float64(k2_args) -> dict:
    """How far K2's f32 gradient rows (dpf) and the float32 plain
    version's lie from a float64 walk, on the deep instances (after each
    tile's first 256) of the K2_F64_TILES deepest tiles of the first
    training step; the float64 forward of those tiles seeds the float64
    backward. Tiles where K1, the float32 plain forward or the float64 one
    stop at different instances are left out. Readings (`k2_readings`, per
    instance over the largest |float64| of its 256-instance group, and per
    row), for the kernel, the plain version and the control -- the
    kernel's output CONTROL_ERR off on the deep instances."""
    from vegs_torch.ops import blend_cuda

    pf, pa, ts, out, dout, grid = k2_args
    hp, wp = grid.padded_height, grid.padded_width
    k = pf.shape[1]
    tiles = sorted(torch.topk(ts[1:] - ts[:-1], K2_F64_TILES).indices.tolist())
    t0 = time.perf_counter()
    _, stop = blend_cuda.blend(pf, pa, ts, grid, hp, wp, return_stop=True)
    fwd = {dt: blend_cuda.blend_ref_tiles(pf, pa, ts, grid, hp, wp,
                                          return_stop=True, tiles=tiles,
                                          dtype=dt)
           for dt in (torch.float32, torch.float64)}
    kpf, _ = blend_cuda.blend_bwd(*k2_args)
    rpf, _ = blend_cuda.blend_bwd_ref_tiles(*k2_args, tiles=tiles)
    out64 = fwd[torch.float64][0]
    xpf, _ = blend_cuda.blend_bwd_ref_tiles(pf, pa, ts, out64, dout, grid,
                                            tiles=tiles, dtype=torch.float64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same = (stop == fwd[torch.float32][1]) & (stop == fwd[torch.float64][1])
    tile_ok = same.reshape(grid.nty, grid.tile_h, grid.ntx, grid.tile_w
                           ).all(dim=3).all(dim=1).reshape(-1)
    kept = torch.zeros(grid.num_tiles, dtype=torch.bool, device=ts.device)
    kept[tiles] = True
    kept &= tile_ok
    tile, batch = slot_tiles(ts, k, grid)
    live = torch.arange(k, device=ts.device) < int(ts[-1])
    deep = kept[tile] & (batch > 0) & live
    ref = xpf.float()
    ctl = deep_control(ts, k, grid)
    res = {"tiles": len(tiles), "kept_tiles": int(kept.sum()),
           "deep_instances": int(deep.sum()),
           "nonzero_dop": int((xpf[5][deep] != 0).sum()),
           "plain_f64_seconds": seconds,
           "kernel": k2_readings(kpf, ref, ts, grid, deep, 0.0),
           "plain_f32": k2_readings(rpf, ref, ts, grid, deep, 0.0),
           "control": k2_readings(kpf * ctl, ref, ts, grid, deep, 0.0)}
    res["kernel_closer"] = res["kernel"]["group"] < res["plain_f32"]["group"]
    return res


def compare_k3(cols, starts, ends):
    """K3 in the JAX contract vs segment_reduce_ref (index_add_, atomics
    on the card) on the same CUDA inputs; the tolerance scales with each
    segment's |x| sum."""
    from vegs_torch.ops import segreduce

    got = segreduce.segment_reduce_cols(cols, starts, ends)
    t0 = time.perf_counter()
    ref = segreduce.segment_reduce_ref(cols, starts, ends)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    mag = segreduce.segment_reduce_ref(cols.abs(), starts, ends)
    # the control: each nonempty segment's last column left out (an
    # off-by-one segment end)
    short = segreduce.segment_reduce_ref(
        cols, starts, torch.maximum(ends - 1, starts))
    d = (got - ref).abs()

    def reading(x):
        return float(((x - ref).abs() / mag.clamp(min=1e-30)).max())

    if not torch.isfinite(got).all():
        raise AssertionError("K3 output is not finite")
    return {"segments": int(starts.shape[0]), "columns": int(cols.shape[1]),
            "rows": int(cols.shape[0]), "summed": int(ends[-1] - starts[0]),
            "max_abs_err": float(d.max()), "reading": reading(got),
            "control_reading": reading(short), "plain_ms": plain_s * 1e3}


def k3_contract_library(cols, starts, ends):
    """K3's JAX contract as one library call: `torch.segment_reduce` of the
    summed columns with each segment's length (contiguous segments from
    column 0). Returns the call."""
    data = cols[:, :int(ends[-1])].contiguous()
    lengths = (ends - starts).long().expand(cols.shape[0], -1).contiguous()
    return lambda: torch.segment_reduce(data, "sum", lengths=lengths, axis=1)


def k3_library(pay_f32, aux_dtype, gidx):
    """K3's library yardstick: autograd's own backward of the payload
    gather, as `GatherExpand` would run without K3 -- `pay_f32[gidx].T
    .contiguous()` and its aux half, built once from leaf tables that
    require grad (the backward reads none of their values: the aux table is
    zeros of the step's aux dtype). Returns backward(d_pf, d_pa) ->
    (d_pay_f32 [n+1, 8], d_pay_aux [n+1, 16]): `torch.autograd.grad` of the
    two gathers with K2's cotangents (an accumulating `index_put_` on each
    row-major table)."""
    pf = pay_f32.detach().clone().requires_grad_(True)
    pa = torch.zeros((pf.shape[0], 16), dtype=aux_dtype, device=pf.device,
                     requires_grad=True)
    g = gidx.long()
    outs = (pf[g].T.contiguous(), pa[g].T.contiguous())

    def backward(d_pf, d_pa):
        return torch.autograd.grad(outs, (pf, pa), (d_pf, d_pa),
                                   retain_graph=True)

    return backward


def k3_index_add(d_pf, d_pa, gidx, rows):
    """The gather's backward as one `index_add_` of the channel-major
    cotangents by `gidx` per table ([8 | 16, rows] f32; the aux half added
    in float32): an earlier yardstick, read under its own name."""
    f = torch.zeros((8, rows), device=d_pf.device).index_add_(1, gidx, d_pf)
    a = torch.zeros((16, rows), device=d_pf.device).index_add_(
        1, gidx, d_pa.float())
    return f, a


def compare_k3_fused(k3_args, st):
    """K3 as the main path runs it (`gather_expand_bwd`) vs its plain
    version on the same CUDA inputs. Readings per row set, of each
    segment's |x| sum: the f32 rows |d|, the aux rows |d| less one bf16 ulp
    of |ref| (the two sums round to bf16 apart); the control is the plain
    sum with each segment's last row left out. The library yardstick
    (`k3_library` on the `Staged` `st`'s payload rows and gather index) is
    held the same way against the kernel on rows 0..n-1 (the dummy row n
    gathers the tail slots, and K3 gives it an empty segment); without `st`
    there is no yardstick to hold."""
    from vegs_torch.ops import segreduce

    d_pf, d_pa, order, ends = k3_args
    got = segreduce.gather_expand_bwd(*k3_args)
    t0 = time.perf_counter()
    ref = segreduce.gather_expand_bwd_ref(*k3_args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    cols, starts, _ = segreduce.cotangent_columns(*k3_args)
    mag = segreduce.segment_reduce_ref(cols.abs(), starts, ends).T
    short = segreduce.segment_reduce_ref(
        cols, starts, torch.maximum(ends - 1, starts)).T
    ulp = BF16_ULP if d_pa.dtype == torch.bfloat16 else 0.0
    halves = {"f32_rows": (slice(0, 8), 0.0), "aux_rows": (slice(8, 24), ulp)}

    def reading(x, r, sl, u):
        d = ((x.float() - r.float()).abs() - u * r.float().abs()).clamp(min=0)
        return float((d / mag[:x.shape[0], sl].clamp(min=1e-30)).max())

    n = ends.shape[0] - 1
    lib = (None if st is None else
           k3_library(st.pay_rows, d_pa.dtype, st.binned.gidx)(d_pf, d_pa))

    res = {"segments": int(ends.shape[0]), "rows": int(ends[-1]),
           "live_rows": int((order[:int(ends[-1])] < d_pf.shape[1]).sum()),
           "aux": str(d_pa.dtype), "plain_ms": plain_s * 1e3,
           "layout": {"dpf": list(got[0].stride()), "dpa": list(got[1].stride()),
                      "contiguous": all(x.is_contiguous() for x in got)}}
    for name, (sl, u) in halves.items():
        i = 0 if name == "f32_rows" else 1
        if not torch.isfinite(got[i]).all():
            raise AssertionError(f"fused K3 {name} not finite")
        ctl = short[:, sl].to(got[i].dtype)
        res[name] = {"reading": reading(got[i], ref[i], sl, u),
                     "control_reading": reading(ctl, ref[i], sl, u),
                     "max_abs_err": float((got[i].float()
                                           - ref[i].float()).abs().max())}
        if lib is not None:
            res[name]["library_reading"] = reading(lib[i][:n], got[i][:n],
                                                   sl, u)
    res["max_abs_err"] = max(res[n]["max_abs_err"] for n in halves)
    if not res["layout"]["contiguous"]:
        raise AssertionError(f"fused K3 outputs not contiguous: {res}")
    return res


def gather_bwd_times(k3_args) -> dict:
    """The gather's backward two ways on the same inputs, the card's own
    time per call (torch.profiler) and its device operations, in turns:
    K3 as the main path runs it (the cotangents staged slot-major, then
    the reduce), and the columns path (cotangent_columns, K3 on the
    columns, the transposed views and the aux cast)."""
    from vegs_torch.ops import segreduce
    from vegs_torch.perf.timing import device_profile

    aux = k3_args[1].dtype

    def columns_path():
        out = segreduce.segment_reduce_cols(
            *segreduce.cotangent_columns(*k3_args))
        return out[:8].T, out[8:].T.to(aux)

    runs = {"fused": [], "columns": []}
    for name in ("columns", "fused", "fused", "columns"):
        fn = (columns_path if name == "columns"
              else lambda: segreduce.gather_expand_bwd(*k3_args))
        p = device_profile(fn)
        runs[name].append((p["device_ms"], p["device_ops"]))
    return {name: {"device_ms": float(np.mean([r[0] for r in rs])),
                   "device_ops": rs[0][1], "runs_ms": [r[0] for r in rs]}
            for name, rs in runs.items()}


def grad_boxes(rng, caps=GRAD_BOX_CAPS):
    """The grad phase's two box instances (numpy): canonical fields of
    3,000 and 5,000 Gaussians on the box's faces, at opacities near a box
    field's seed (~0.18), at capacities 4096 and 8192 (different, so the
    concatenated rows of the parts differ from a pooled layout), small
    boxes at depths 1.1 and 1.35, in front of the static field (from depth
    1.5; an occluded Gaussian gets no gradient at all past the sat cull),
    yaw 0.3 and 1.1 rad (away from the ties of `rotmat_to_quat`),
    residuals a little off identity."""
    boxes = []
    for (n, cap), yaw, t in zip(caps, (0.3, 1.1),
                                ((-0.3, 0.03, 1.1), (0.35, -0.03, 1.35))):
        f = {"means": np.zeros((cap, 3)), "quats": np.zeros((cap, 4)),
             "log_scales": np.full((cap, 3), np.log(1e-7)),
             "sh_dc": np.zeros((cap, 1, 3)), "sh_rest": np.zeros((cap, 15, 3)),
             "opacity_logit": np.zeros((cap, 1)), "valid": np.zeros(cap, bool)}
        f["means"][:n] = surface_points(rng, n)
        f["quats"][:n] = rng.normal(size=(n, 4))
        f["log_scales"][:n] = np.log(rng.uniform(0.01, 0.03, (n, 3)))
        f["sh_dc"][:n] = rng.normal(0, 0.5, (n, 1, 3))
        f["sh_rest"][:n] = rng.normal(0, 0.1, (n, 15, 3))
        f["opacity_logit"][:n] = rng.normal(-1.5, 0.5, (n, 1))
        f["valid"][:n] = True
        deltas = {"delta_r": np.r_[1.0, 0, 0, 0] + rng.normal(0, 0.02, 4),
                  "delta_s": 1.0 + rng.normal(0, 0.02, 3),
                  "delta_t": rng.normal(0, 0.05, 3)}
        boxes.append((f, car_box2world(yaw, t, size=(0.3, 0.2, 0.25)), deltas))
    return boxes


def surface_points(rng, n) -> np.ndarray:
    """n points uniform on the canonical unit box's six faces."""
    p = rng.uniform(-0.5, 0.5, (n, 3))
    face = rng.integers(0, 6, n)
    p[np.arange(n), face // 2] = np.where(face % 2, 0.5, -0.5)
    return p


def car_box2world(yaw, center, size=CAR_SIZE) -> np.ndarray:
    """The canonical unit box -> world: a yaw about the (down-pointing) y
    axis, per-axis size (length, height, width), the center."""
    c, s_ = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]]
                         ) @ np.diag(size)
    m[:3, 3] = center
    return m.astype(np.float32)


def bf16_steps(a, b):
    """|a - b| in bf16 rounding steps, per value (a, b bfloat16; +0 = -0)."""
    def key(x):
        v = bits(x).to(torch.int32)
        return torch.where(v >= 0, v, -(v & 0x7FFF))
    return (key(a) - key(b)).abs()


class k3_colour_rows:
    """For one run, wraps the gather's backward (K3 on the card, its plain
    version on the CPU) and records its bf16 gradient of the `rows`' colour
    columns (the aux table's rgb, 0:3) as `.got`. With `adopt` (another
    run's record) the run takes that record's value where the two are
    exactly one bf16 step apart, so that one rounding of the same float32
    sum to either neighbour is all that is let through; with `shift` every
    nonzero value moves one step toward zero first (a fault for the
    control: what the check must not let through on every value)."""

    def __init__(self, rows, adopt=None, shift=False):
        self.rows, self.adopt, self.shift, self.got = rows, adopt, shift, None

    def __enter__(self):
        from vegs_torch.ops import rasterize

        self.mod, self.orig = rasterize, rasterize.gather_expand_bwd

        def wrapped(*args):
            dpf, dpa = self.orig(*args)
            col = dpa[self.rows, :3]
            if self.shift:
                col = torch.where(col != 0, (bits(col) - 1).view(col.dtype),
                                  col)
            self.got = col.cpu()
            if self.adopt is not None:
                other = self.adopt.to(col.device)
                col = torch.where(bf16_steps(col, other) == 1, other, col)
            dpa = dpa.clone()
            dpa[self.rows, :3] = col
            return dpf, dpa

        rasterize.gather_expand_bwd = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.gather_expand_bwd = self.orig


def grad_check(dev, n=50_000, seed=SEED):
    """One step's gradients through the kernels (card) and the plain
    versions (CPU tensors) on a reduced scene with two box instances: the
    relative L2 error of every leaf -- the static field's, the means2d
    tap, each box field's and each box's residual -- and the same for the
    control: the kernel path with K2's f32 gradient rows rounded to bf16
    (as a kernel that wrote them in the aux dtype would), through a tensor
    hook on the blend's payload, and K3's box colour rows each one bf16
    step toward zero.

    A box's colour leaves are its K3 aux colour row (bf16; a box Gaussian
    has about one instance, so K2's float32 order decides where that row
    rounds) times SH constants: the plain run takes the card's value where
    the two rows are one bf16 step apart (`k3_colour_rows`), and the share
    of such values is held by COLOUR_MAX_FLIP_SHARE."""
    from vegs_torch import boxmodel, convert
    from vegs_torch.config import VegsConfig
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.perf.refscale import origin_camera
    from vegs_torch.render import BoxInstance
    from vegs_torch.train import loss_fn
    from vegs_torch.utils.synthetic import unit_normal_map

    h, w = 128, 512
    rng = np.random.default_rng(seed + 7)
    z = rng.uniform(1.5, 10.0, n)
    arrays = {
        "means": np.stack([rng.uniform(-0.5, 0.5, n) * z,
                           rng.uniform(-0.14, 0.14, n) * z, z], 1),
        "quats": rng.normal(size=(n, 4)),
        "log_scales": np.log(rng.uniform(0.01, 0.1, (n, 3))),
        "sh_dc": rng.normal(0, 0.5, (n, 1, 3)),
        "sh_rest": rng.normal(0, 0.1, (n, 15, 3)),
        "opacity_logit": rng.normal(0, 1.5, (n, 1)),
        "valid": np.ones(n, bool),
    }
    gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    normal = unit_normal_map(h, w, seed)
    boxes_np = grad_boxes(rng)
    rows = n + sum(b[0]["valid"].shape[0] for b in boxes_np)
    cfg = RasterizeConfig(k_cap=1 << 21, k_pad=1 << 21)
    opt = VegsConfig().opt
    lam = VegsConfig().box.boxmodel_lambda_reg
    grads, times, colour = {}, {}, {}
    box_rows = slice(n, rows)
    for run, d in (("card", dev), ("control", dev),
                   ("plain", torch.device("cpu"))):
        field = convert.field_from_numpy(arrays, device=d)
        bfields = [convert.field_from_numpy(b[0], device=d) for b in boxes_np]
        deltas = [boxmodel.BoxDeltas(**{
            k: torch.tensor(v, dtype=torch.float32, device=d,
                            requires_grad=True) for k, v in b[2].items()})
            for b in boxes_np]
        insts = [BoxInstance(f, torch.from_numpy(b[1]).to(d), dl)
                 for f, b, dl in zip(bfields, boxes_np, deltas)]
        tap = torch.zeros((rows, 2), device=d, requires_grad=True)
        cam = origin_camera(h, w, 1.0, 0.3, d)
        args = (torch.from_numpy(gt).to(d), torch.from_numpy(normal).to(d))
        t0 = time.perf_counter()
        if run == "control":
            loss, st, _ = staged_loss(field, tap, cam, *args, 3,
                                      torch.zeros(3, device=d), opt, cfg,
                                      boxes=insts, lambda_reg=lam)
            st.payload_f32.register_hook(
                lambda g: g.to(torch.bfloat16).to(torch.float32))
            dropped = st.binned.num_dropped
        else:
            loss, _, _, out = loss_fn(field, tap, cam, *args, 1.0, 3,
                                      torch.zeros(3, device=d), opt_cfg=opt,
                                      raster_cfg=cfg, boxes=insts,
                                      lambda_reg=lam)
            dropped = out.num_dropped
        with k3_colour_rows(box_rows, shift=run == "control",
                            adopt=colour["card"] if run == "plain"
                            else None) as wrap:
            loss.backward()
        colour[run] = wrap.got
        if d.type == "cuda":
            torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        if int(dropped):
            raise AssertionError("the gradient-check scene drops instances")
        grads[run] = {k: getattr(field, k).grad.cpu()
                      for k in convert.FIELD_KEYS[:-1]}
        grads[run]["means2d"] = tap.grad.cpu()
        for i, (f, dl) in enumerate(zip(bfields, deltas)):
            for k in convert.FIELD_KEYS[:-1]:
                grads[run][f"box{i} {k}"] = getattr(f, k).grad.cpu()
            for k in boxmodel.BoxDeltas.LEAVES:
                grads[run][f"delta{i} {k}"] = getattr(dl, k).grad.cpu()
    errs = {"card": {}, "control": {}}
    for k, ref in grads["plain"].items():
        for run in errs:
            got = grads[run][k]
            if not torch.isfinite(got).all() or float(ref.norm()) == 0:
                raise AssertionError(f"step gradient {k}: not finite or zero")
            errs[run][k] = float((got - ref).norm() / ref.norm())
    box_leaves = [k for k in errs["card"] if k.startswith(("box", "delta"))]
    colour_leaves = [k for k in box_leaves if k.endswith(("sh_dc", "sh_rest"))]
    live = (colour["plain"] != 0) | (colour["card"] != 0)
    steps = {run: bf16_steps(colour[run], colour["plain"])[live]
             for run in errs}
    flips = {run: {"one_step": int((s == 1).sum()),
                   "beyond_one_step": int((s > 1).sum())}
             for run, s in steps.items()}
    return {"scene": f"{h}x{w}, {n} Gaussians and 2 boxes "
                     f"({', '.join(str(b[0]['valid'].sum()) for b in boxes_np)}"
                     f" Gaussians at capacities "
                     f"{', '.join(str(len(b[0]['valid'])) for b in boxes_np)}"
                     "), bf16 aux",
            "rel_l2_err": errs["card"],
            "reading": max(errs["card"].values()),
            "box_reading": max(errs["card"][k] for k in box_leaves),
            "colour_reading": max(errs["card"][k] for k in colour_leaves),
            "colour_values": int(live.sum()),
            "colour_flips": flips["card"],
            "colour_flip_share": flips["card"]["one_step"] / int(live.sum()),
            "control_rel_l2_err": errs["control"],
            "control_reading": max(errs["control"].values()),
            "box_control_reading": max(errs["control"][k] for k in box_leaves),
            "colour_control_reading": max(errs["control"][k]
                                          for k in colour_leaves),
            "colour_control_flips": flips["control"],
            "colour_control_flip_share": (flips["control"]["one_step"]
                                          / int(live.sum())),
            "card_s": times["card"], "plain_cpu_s": times["plain"]}


def main_counters() -> dict:
    """The launch counters of the main paths' kernels, K1-K4
    (`vegs_torch.perf.main_counters`)."""
    from vegs_torch import perf

    return perf.main_counters()


def train_phase(scene, dev, card) -> dict:
    """The training path at full width on `scene`'s field (see phase 7)."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.render import render
    from vegs_torch.train import Trainer
    from vegs_torch.utils.synthetic import unit_normal_map

    cams = scene.getTrainCameras()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cfg, need_raw, need_pad = sized_config(scene.gaussians, cams, dev)
        for i, cam in enumerate(cams):  # ground truth: the unperturbed field
            out = render(cam, scene.gaussians,
                         config=cfg._replace(forward_only=True))
            if int(out.num_dropped):
                raise AssertionError("ground-truth render drops instances")
            cam.image = torch.clamp(out.rgb, 0, 1).cpu().numpy()
            cam.normal = unit_normal_map(H, W, seed=i)
    with torch.no_grad():
        scene.gaussians.sh_dc += 0.35
    tcfg = VegsConfig()
    tcfg.opt.densification_interval = DENSIFY_EVERY
    trainer = Trainer(tcfg, scene, raster_cfg=cfg, device=dev)
    k2_args, k3_args, k4_st, k_loss = step_kernel_inputs(
        trainer, cams[TRAIN_CAMS[0]], TRAIN_FIRST_IT, dev)
    setup_s = time.perf_counter() - t0

    counters = main_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    steps = []
    its = range(TRAIN_FIRST_IT, TRAIN_FIRST_IT + TRAIN_STEPS)
    for it, ci in zip(its, TRAIN_CAMS):
        before = {k: c.launches for k, c in counters.items()}
        n_before = trainer.state.field.capacity
        t1 = time.perf_counter()
        m = trainer.train_iteration(it, camera=cams[ci])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        steps.append({"it": it, "cam": ci, "ms": dt * 1e3,
                      "densify": it % DENSIFY_EVERY == 0,
                      "launches": {k: c.launches - before[k]
                                   for k, c in counters.items()},
                      "capacity": [n_before, trainer.state.field.capacity],
                      **{k: m[k] for k in ("loss", "l1", "normal_loss",
                                            "num_dropped", "num_needed",
                                            "num_needed_raw")}})
        if m["num_dropped"]:
            raise AssertionError(f"step {it} dropped instances: {steps[-1]}")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and descending: {losses}")
    if abs(k_loss - losses[0]) > 1e-6 * abs(losses[0]):
        raise AssertionError(f"the loss of K2's, K3's and K4's inputs {k_loss} "
                             f"is not the first step's {losses[0]}")
    for st in steps:
        if any(v != 1 for v in st["launches"].values()):
            raise AssertionError(f"a step did not launch each kernel once: {st}")
    n_densify = sum(st["densify"] for st in steps)
    if n_densify != 1:
        raise AssertionError(f"{n_densify} densify events in the run")
    plain_steps = [st["ms"] for st in steps[1:] if not st["densify"]]
    with torch.inference_mode():  # capacities for the densified field
        new, re_raw, re_pad = sized_config(trainer.state.field, cams, dev)
    trainer.raster_cfg = trainer.raster_cfg._replace(
        k_cap=max(new.k_cap, trainer.raster_cfg.k_cap),
        k_pad=max(new.k_pad, trainer.raster_cfg.k_pad))
    res = {"steps": TRAIN_STEPS, "first_it": TRAIN_FIRST_IT,
           "capacity": trainer.state.field.capacity,
           "n_active": [N_REF, int(trainer.state.field.num_active())],
           "k_cap": cfg.k_cap, "k_pad": cfg.k_pad, "need_raw": need_raw,
           "need_pad": need_pad,
           "after_densify": {"need_raw": re_raw, "need_pad": re_pad,
                             "k_cap": trainer.raster_cfg.k_cap,
                             "k_pad": trainer.raster_cfg.k_pad},
           "loss": losses, "kernel_inputs_loss": k_loss,
           "ms_per_step": float(np.median(plain_steps)),
           "ms_steps": [st["ms"] for st in steps],
           "densify_step_ms": next(st["ms"] for st in steps if st["densify"]),
           "max_memory_allocated": peak, "launches": launches,
           "setup_s": setup_s, "per_step": steps}
    emit("train", card=card, **res)

    after = []

    def two_steps():
        for it, ci in zip(range(its.stop, its.stop + 2), TRAIN_CAMS):
            after.append(trainer.train_iteration(it, camera=cams[ci]))

    prof = profile_frames(two_steps)
    if any(m["num_dropped"] or not np.isfinite(m["loss"]) for m in after):
        raise AssertionError(f"steps on the densified field: {after}")
    emit("train_profile", card=card, steps=2,
         loss=[m["loss"] for m in after], **prof)
    res["k2_args"], res["k3_args"], res["k4_st"] = k2_args, k3_args, k4_st
    return res


def sized_config(field, cams_augs, device, boxes_of=None,
                 probe_cap=PROBE_CAP, tile=(16, 16)):
    """Probe every view (a camera, or its CameraParams) at a generous
    capacity and size k_cap/k_pad by the largest need + 5% (as bench.py
    does), with the sat cull on, at `tile` (tile_h, tile_w). With
    `boxes_of` (camera -> its frame's `BoxInstance`s) the boxes are
    rendered with the field, as `render_all` does."""
    from vegs_torch.ops.rasterize import RasterizeConfig

    from vegs_torch.ops.projection import CameraParams

    th, tw = tile
    probe = RasterizeConfig(k_cap=probe_cap, k_pad=probe_cap, sat_cull=True,
                            forward_only=True, tile_h=th, tile_w=tw)
    need_raw = need_pad = 0
    for cam in cams_augs:
        boxes = boxes_of(cam) if boxes_of else ()
        params = (cam if isinstance(cam, CameraParams)
                  else cam.device_params(device))
        st = field_stage(field, params, probe, boxes)
        total = int(st.rb.total)
        if total > probe_cap:
            raise AssertionError(f"probe capacity {probe_cap} < need {total}")
        need_raw = max(need_raw, total)
        need_pad = max(need_pad, int(st.binned.tile_starts[-1]))
    return RasterizeConfig(k_cap=r512(need_raw * 1.05),
                           k_pad=r512(need_pad * 1.05), tile_h=th,
                           tile_w=tw), need_raw, need_pad


def write_field_ply(path: Path, n: int, seed: int) -> None:
    """`synthetic_field(n, seed)` written as a PLY."""
    from vegs_torch.scene import save_gaussian_ply

    save_gaussian_ply(path, synthetic_field(n, seed))


def synthetic_field(n: int, seed: int):
    """A seeded synthetic trained field (SH degree 3, on the CPU) placed
    like bench.py: depth in [2, 60], x/y filling the 376x1408 frustum (fovx
    1.2, fovy 0.4) so that nearly every Gaussian is visible."""
    from vegs_torch import gaussians

    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 60.0, n).astype(np.float32)
    u = rng.uniform(-0.95, 0.95, n)
    v = rng.uniform(-0.95, 0.95, n)
    xyz = np.stack([z * np.tan(0.6) * u, z * np.tan(0.2) * v, z], 1).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    scale = np.log(rng.uniform(0.002, 0.025, (n, 3))).astype(np.float32)
    op = rng.uniform(0.2, 0.95, n)
    opac = np.log(op / (1 - op)).astype(np.float32)
    f_dc = rng.uniform(-1.0, 1.5, (n, 3)).astype(np.float32)
    f_rest = rng.normal(0, 0.12, (n, 45)).astype(np.float32)
    return gaussians.from_ply_arrays(xyz, f_dc, f_rest, opac, scale, rot,
                                     device="cpu")


def box_poses(n_frames=3):
    """{frame: {instance: box2world}} of the boxes phase's vehicles: car
    boxes at depths BOX_DEPTHS across the frame, yaw angles BOX_YAWS (away
    from the ties of `rotmat_to_quat` at 0 and pi/2), each driving 0.6 m
    along x per frame."""
    poses = {f: {} for f in range(n_frames)}
    for j, (z, yaw, u) in enumerate(zip(BOX_DEPTHS, BOX_YAWS, BOX_LATERAL)):
        for f in range(n_frames):
            center = (u * np.tan(0.6) * z + 0.6 * f, 0.05 * z, z)
            poses[f][BOX_INST0 + j] = car_box2world(yaw, center)
    return poses


def footprint_share(cam, box2world) -> float:
    """The share of the frame inside the screen rectangle of a box's eight
    projected corners (clipped to the frame; 0 if a corner lies behind the
    near plane)."""
    corners = np.array([[x, y, z, 1.0] for x in (-0.5, 0.5)
                        for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    p = corners @ box2world.T.astype(np.float64) @ cam.full_proj_transform
    if (p[:, 3] <= 0.2).any():
        return 0.0
    px = ((p[:, 0] / p[:, 3] + 1.0) * cam.image_width - 1.0) * 0.5
    py = ((p[:, 1] / p[:, 3] + 1.0) * cam.image_height - 1.0) * 0.5
    w = np.clip(px.max(), 0, cam.image_width) - np.clip(px.min(), 0,
                                                         cam.image_width)
    h = np.clip(py.max(), 0, cam.image_height) - np.clip(py.min(), 0,
                                                          cam.image_height)
    return float(w * h / (cam.image_width * cam.image_height))


def boxes_phase(dev, card) -> dict:
    """The dynamic-scene training path at full width (see phase 10)."""
    from vegs_torch import optim
    from vegs_torch.boxmodel import BoxDeltas
    from vegs_torch.config import ModelParams, VegsConfig
    from vegs_torch.ops import rasterize
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.render import BoxInstance, render_all
    from vegs_torch.scene import Scene, initialize_box_field, save_gaussian_ply
    from vegs_torch.scene.dataset_readers import (DynamicPointCloud,
                                                  SceneInfo, getNerfppNorm)
    from vegs_torch.train import Trainer
    from vegs_torch.utils.synthetic import (mover_canonical_points,
                                            street_camera_infos,
                                            unit_normal_map)

    t0 = time.perf_counter()
    poses = box_poses()
    insts = list(poses[0])
    rng = np.random.default_rng(SEED + 11)
    pts, cols = zip(*[mover_canonical_points(rng, n=BOX_POINTS)
                      for _ in insts])
    world = [(np.c_[p, np.ones(len(p))] @ poses[0][i].T)[:, :3]
             for p, i in zip(pts, insts)]
    dyn = DynamicPointCloud(
        points=np.concatenate(world).astype(np.float32),
        colors=np.concatenate(cols),
        instances=np.repeat(insts, [len(p) for p in pts]),
        timestamps=np.zeros(sum(len(p) for p in pts), int))
    infos = street_camera_infos(3, H, W, fovx=1.2, fovy=0.4)
    info = SceneInfo(point_cloud=None, train_cameras=infos, test_cameras=[],
                     nerf_normalization=getNerfppNorm(infos), ply_path="",
                     dyn_point_cloud=dyn, train_bboxes=poses,
                     instances_info=insts)
    with tempfile.TemporaryDirectory() as model_dir:
        base = Path(model_dir)
        write_field_ply(base / "point_cloud" / "iteration_1"
                        / "point_cloud.ply", N_REF, SEED)
        for i in insts:  # each instance's field, from its points
            save_gaussian_ply(base / f"instance_{i}" / "point_cloud"
                              / "iteration_1" / "point_cloud.ply",
                              initialize_box_field(dyn, i, poses,
                                                   device="cpu"))
        scene = Scene(ModelParams(model_path=model_dir), scene_info=info,
                      load_iteration=-1, shuffle=False, device=dev)
    cams = scene.getTrainCameras()
    shares = {f"{c.frame}/{i}": footprint_share(c, poses[c.frame][i])
              for c in cams for i in insts}
    if min(shares.values()) < 0.005:
        raise AssertionError(f"a box covers < 0.5% of a frame: {shares}")
    box_rows = {i: int(f.num_active()) for i, f in scene.box_gaussians.items()}
    tcfg = VegsConfig()
    tcfg.opt.densification_interval = DENSIFY_EVERY
    trainer = Trainer(tcfg, scene, raster_cfg=RasterizeConfig(), device=dev)
    setup_s = time.perf_counter() - t0

    # 1. the normal-prior init, on the 3 cameras' normal maps
    for i, cam in enumerate(cams):
        cam.normal = unit_normal_map(H, W, seed=i)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_init = trainer.init_from_normals()
    torch.cuda.synchronize()
    norm_init_ms = (time.perf_counter() - t1) * 1e3

    def boxes_of(cam, deltas=False):
        f = int(cam.frame)
        return [BoxInstance(trainer.box_fields[i],
                            torch.from_numpy(poses[f][i]).to(dev),
                            trainer.frame_deltas.get((f, i)) if deltas
                            else None) for i in insts]

    # 2. ground truth at the annotated poses, then perturbed colours and
    # residuals a seeded 0.05 off identity
    with torch.inference_mode():
        cfg, need_raw, need_pad = sized_config(
            trainer.state.field, cams, dev, boxes_of, BOX_PROBE_CAP)
        tiles = -(-H // 16) * -(-W // 16)
        if cfg.k_cap < rasterize.SAT_MIN_SLOTS_PER_TILE * tiles:
            raise AssertionError("the sat-cull gate should be on at this scale")
        for cam in cams:
            out, _ = render_all(cam.device_params(dev), trainer.state.field,
                                boxes_of(cam), bg=trainer.bg,
                                config=cfg._replace(forward_only=True))
            if int(out.num_dropped):
                raise AssertionError("ground-truth render drops instances")
            cam.image = torch.clamp(out.rgb, 0, 1).cpu().numpy()
    trainer.raster_cfg = cfg
    with torch.no_grad():
        for f in [trainer.state.field, *trainer.box_fields.values()]:
            f.sh_dc += 0.35
    for cam in cams:
        for i in insts:
            d = BoxDeltas.identity(device=dev)
            off = rng.normal(size=3)
            d.delta_t = torch.tensor(0.05 * off / np.linalg.norm(off),
                                     dtype=torch.float32, device=dev)
            trainer.frame_deltas[(int(cam.frame), i)] = d
            trainer.frame_delta_opts[(int(cam.frame), i)] = \
                optim.tensor_adam_init(d.as_dict())

    def delta_err():
        return float(torch.stack([d.delta_t.norm() for d in
                                  trainer.frame_deltas.values()]).mean())

    err_before = delta_err()

    # 3. eight box steps, one densify at 3008 over the field and every box
    counters = main_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    steps = []
    caps_before = {i: f.capacity for i, f in trainer.box_fields.items()}
    its = range(TRAIN_FIRST_IT, TRAIN_FIRST_IT + TRAIN_STEPS)
    for it, ci in zip(its, TRAIN_CAMS):
        before = {k: c.launches for k, c in counters.items()}
        t1 = time.perf_counter()
        m = trainer.train_iteration(it, camera=cams[ci])
        torch.cuda.synchronize()
        steps.append({"it": it, "cam": ci, "ms": (time.perf_counter() - t1) * 1e3,
                      "densify": it % DENSIFY_EVERY == 0,
                      "launches": {k: c.launches - before[k]
                                   for k, c in counters.items()},
                      **{k: m[k] for k in ("loss", "num_dropped",
                                            "num_needed", "num_needed_raw")}})
        if m["num_dropped"]:
            raise AssertionError(f"box step {it} dropped instances: {steps[-1]}")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    caps_after = {i: f.capacity for i, f in trainer.box_fields.items()}
    err_after = delta_err()
    losses = [st["loss"] for st in steps]
    if not np.isfinite(losses).all():
        raise AssertionError(f"box step losses not finite: {losses}")
    if any(v != TRAIN_STEPS for v in launches.values()):
        raise AssertionError(f"K1-K4 launches in {TRAIN_STEPS} box steps: "
                             f"{launches}")
    if not (np.isfinite(err_before) and np.isfinite(err_after)):
        raise AssertionError(f"delta errors {err_before}, {err_after}")
    n_rows_after = {i: int(f.num_active()) for i, f in trainer.box_fields.items()}
    if n_rows_after == box_rows:
        raise AssertionError("the densify left every box as it was")

    # where a box step's time goes: 2 more steps, on the densified fields
    with torch.inference_mode():
        new, _, _ = sized_config(trainer.state.field, cams, dev,
                                 lambda c: boxes_of(c, deltas=True),
                                 BOX_PROBE_CAP)
    trainer.raster_cfg = trainer.raster_cfg._replace(
        k_cap=max(new.k_cap, trainer.raster_cfg.k_cap),
        k_pad=max(new.k_pad, trainer.raster_cfg.k_pad))
    after = []

    def two_steps():
        for it, ci in zip(range(its.stop, its.stop + 2), TRAIN_CAMS):
            after.append(trainer.train_iteration(it, camera=cams[ci]))

    prof = profile_frames(two_steps)
    if any(m["num_dropped"] or not np.isfinite(m["loss"]) for m in after):
        raise AssertionError(f"box steps on the densified fields: {after}")

    # 4. serving with the boxes: render_all on the 3 frames
    with torch.inference_mode():
        scfg, s_raw, s_pad = sized_config(
            trainer.state.field, cams, dev,
            lambda c: boxes_of(c, deltas=True), BOX_PROBE_CAP)
        scfg = scfg._replace(forward_only=True)

        def frame(cam):
            out, _ = render_all(cam.device_params(dev), trainer.state.field,
                                boxes_of(cam, deltas=True), bg=trainer.bg,
                                config=scfg)
            return out

        frame(cams[0])  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t1 = time.perf_counter()
        outs = [frame(cam) for cam in cams]
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t1) * 1e3 / len(cams)
        serve_launches = {k: counters[k].launches for k in ("K1", "K4")}
        for out in outs:
            if int(out.num_dropped) or not torch.isfinite(out.rgb).all():
                raise AssertionError("a render_all frame drops or is not finite")
        st = field_stage(trainer.state.field, cams[0].device_params(dev),
                         scfg, boxes_of(cams[0], deltas=True))
        k4 = compare_k4(st)
        k1 = compare_k1(st)
    plain = [s_["ms"] for s_ in steps[1:] if not s_["densify"]]
    res = {"instances": len(insts), "box_rows": box_rows,
           "box_rows_after": n_rows_after,
           "box_capacity": [caps_before, caps_after],
           "footprint_share": shares, "norm_init_ms": norm_init_ms,
           "norm_init_count": n_init, "k_cap": cfg.k_cap, "k_pad": cfg.k_pad,
           "need_raw": need_raw, "need_pad": need_pad, "loss": losses,
           "ms_per_step": float(np.median(plain)),
           "ms_steps": [s_["ms"] for s_ in steps],
           "densify_step_ms": next(s_["ms"] for s_ in steps if s_["densify"]),
           "max_memory_allocated": peak, "launches": launches,
           "delta_t_err": [err_before, err_after],
           "n_active": [N_REF, int(trainer.state.field.num_active())],
           "serve_ms_per_frame": serve_ms, "serve_launches": serve_launches,
           "serve_need_raw": s_raw, "serve_need_pad": s_pad,
           "setup_s": setup_s, "per_step": steps}
    emit("boxes", card=card, **res)
    emit("boxes_profile", card=card, steps=2,
         loss=[m["loss"] for m in after], **prof)
    scene_name = "376x1408, 2,233,571 Gaussians + 8 boxes, render_all frame"
    emit("k4_check", scene=scene_name, card=card, **k4)
    emit("k1_check", scene=scene_name, aux="bf16", card=card, **k1)
    return {**res, "k1": k1, "k4": k4}


# the cli phase: a synthetic KITTI-360 segment on disk, read and trained by
# the CLI (`vegs_torch.train.main`)
CLI_SEQ = "2013_05_28_drive_0009_sync"
CLI_START, CLI_FRAMES = 3972, 8
CLI_COLMAP, CLI_HIDDEN = 100_000, 200_000   # the LiDAR cloud holds the rest
# the reference's rectified intrinsics (tests/test_scene.py:88-95), a
# KITTI-360-like stereo baseline
CLI_K = np.array([[552.55, 0.0, 682.05], [0.0, 552.55, 238.77],
                  [0.0, 0.0, 1.0]])
CLI_BASELINE = 0.6
CLI_ITERS, CLI_CKPT, CLI_DENSIFY = 24, 12, 8
CLI_KCAP_MARGIN = 1.25   # --k_cap over the probed need (densify grows it)


class Observe:
    """Wrap attributes (or dict entries) for one run with wrappers made by
    `factory(original)`, and put the originals back on exit."""

    def __init__(self):
        self.saved = []

    def wrap(self, owner, name, factory):
        get = owner.__getitem__ if isinstance(owner, dict) else (
            lambda n: getattr(owner, n))
        orig = get(name)
        self.saved.append((owner, name, orig))
        new = factory(orig)
        if isinstance(owner, dict):
            owner[name] = new
        else:
            setattr(owner, name, new)

    def timer(self, owner, name, into: list, sync: bool = False):
        def factory(orig):
            def timed(*a, **kw):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return timed
        self.wrap(owner, name, factory)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            if isinstance(owner, dict):
                owner[name] = orig
            else:
                setattr(owner, name, orig)


def write_cli_segment(root: Path, dev) -> dict:
    """The cli phase's synthetic KITTI-360 segment (phase 11). Returns
    {"images": {path: uint8 [H, W, 3]}, ...sizes}."""
    from vegs_torch.render import BoxInstance, render_all
    from vegs_torch.scene import initialize_box_field, load_gaussian_ply
    from vegs_torch.scene.dataset_readers import (DynamicPointCloud,
                                                  camera_from_info,
                                                  readKITTI360Cameras)
    from PIL import Image

    from vegs_torch.sh import sh_to_rgb
    from vegs_torch.utils.synthetic import (kitti360_frame_paths,
                                            mover_canonical_points,
                                            street_camera_infos,
                                            unit_normal_map,
                                            write_kitti360_segment)

    frames = list(range(CLI_START, CLI_START + CLI_FRAMES))
    cam0_to_world = {}
    for f, info in zip(frames, street_camera_infos(CLI_FRAMES, H, W,
                                                    fovx=1.2, fovy=0.4)):
        w2c = np.eye(4)
        w2c[:3, :3] = info.R.T
        w2c[:3, 3] = info.T
        cam0_to_world[f] = np.linalg.inv(w2c)
    poses = box_poses(CLI_FRAMES)
    boxes = {f: poses[i] for i, f in enumerate(frames)}
    insts = list(poses[0])
    rng = np.random.default_rng(SEED + 21)
    dyn = [[] for _ in range(4)]
    for gid in insts:  # each vehicle's points, each seen in one frame
        p, c = mover_canonical_points(rng, n=BOX_POINTS)
        seen = np.arange(len(p)) % CLI_FRAMES
        for i, f in enumerate(frames):
            sel = seen == i
            world = (np.c_[p[sel], np.ones(sel.sum())] @ boxes[f][gid].T)[:, :3]
            for lst, v in zip(dyn, (world, c[sel], np.full(sel.sum(), gid),
                                    np.full(sel.sum(), f))):
                lst.append(v)
    dxyz, dcol, dids, dts = (np.concatenate(v) for v in dyn)
    drgb = np.round(dcol * 255).astype(np.uint8)

    write_field_ply(root.parent / "field.ply", N_REF, SEED)
    field = load_gaussian_ply(root.parent / "field.ply", device=dev)
    xyz = field.means.detach()[:N_REF].cpu().numpy()
    rgb = np.round(np.clip(sh_to_rgb(field.sh_dc.detach()[:N_REF, 0].cpu()
                                     .numpy()), 0, 1) * 255).astype(np.uint8)
    n_lidar = N_REF - CLI_COLMAP
    z = rng.uniform(2.0, 60.0, CLI_HIDDEN)
    hidden = np.stack([z * np.tan(0.6) * rng.uniform(-1, 1, CLI_HIDDEN),
                       z * np.tan(0.2) * rng.uniform(-1, 1, CLI_HIDDEN), z], 1)
    static = (np.concatenate([xyz[:n_lidar], hidden]),
              np.concatenate([rgb[:n_lidar], rng.integers(
                  0, 256, (CLI_HIDDEN, 3)).astype(np.uint8)]),
              np.r_[np.ones(n_lidar), np.zeros(CLI_HIDDEN)])
    write_kitti360_segment(
        root, CLI_SEQ, CLI_START, CLI_START + CLI_FRAMES, CLI_K, W, H,
        cam0_to_world, CLI_BASELINE, static, (xyz[n_lidar:], rgb[n_lidar:]),
        (dxyz, drgb, dids, dts, np.full(len(dids), 26),
         np.ones(len(dids))), boxes)

    # ground truth: the seeded field and the box fields the loader seeds
    dpc = DynamicPointCloud(dxyz.astype(np.float32), drgb / 255.0, dids, dts)
    box_fields = {g: initialize_box_field(dpc, g, boxes, device=dev)
                  for g in insts}
    infos = readKITTI360Cameras(str(root), CLI_SEQ, CLI_START,
                                CLI_START + CLI_FRAMES)
    cams = [camera_from_info(i) for i in infos]

    def boxes_of(cam):
        return [BoxInstance(box_fields[g], torch.from_numpy(
            boxes[cam.frame][g].astype(np.float32)).to(dev)) for g in insts]

    images = {}
    with torch.inference_mode():
        cfg, need_raw, _ = sized_config(field, cams, dev, boxes_of,
                                        BOX_PROBE_CAP)
        for info, cam in zip(infos, cams):
            out, _ = render_all(cam.device_params(dev), field, boxes_of(cam),
                                config=cfg._replace(forward_only=True))
            if int(out.num_dropped):
                raise AssertionError("a ground-truth frame drops instances")
            img = (torch.clamp(out.rgb, 0, 1) * 255).round().to(
                torch.uint8).permute(1, 2, 0).cpu().numpy()
            img_path, normal_path = kitti360_frame_paths(
                root, CLI_SEQ, info.cam_idx, info.frame)
            os.makedirs(os.path.dirname(img_path), exist_ok=True)
            Image.fromarray(img).save(img_path)
            images[img_path] = img
            os.makedirs(os.path.dirname(normal_path), exist_ok=True)
            np.save(normal_path, unit_normal_map(H, W, seed=info.uid))
    return {"images": images, "lidar_points": int(static[2].sum()),
            "hidden_points": CLI_HIDDEN, "colmap_points": CLI_COLMAP,
            "dynamic_points": len(dids), "vehicles": len(insts),
            "gt_need_raw": need_raw}


def png_check(images: dict) -> dict:
    """The written frames read back through the loader's `_load_image`
    (PIL) equal the arrays written, to the bit; its ms per frame."""
    from vegs_torch.scene.cameras import _load_image

    ms = []
    for path, img in images.items():
        t0 = time.perf_counter()
        got = _load_image(path)
        ms.append((time.perf_counter() - t0) * 1e3)
        back = np.round(got.transpose(1, 2, 0) * 255).astype(np.uint8)
        if not np.array_equal(back, img):
            raise AssertionError(f"{path} does not decode to what was written")
    return {"frames": len(images), "decode_ms": float(np.median(ms)),
            "decode_ms_all": ms}


def cli_argv(root: Path, model: Path, k_cap: int, *extra) -> list:
    return ["--source_path", str(root), "--model_path", str(model),
            "--data_type", "kitti360", "--seq", CLI_SEQ,
            "--start_frame", str(CLI_START),
            "--end_frame", str(CLI_START + CLI_FRAMES), "--eval",
            "--iterations_override", str(CLI_ITERS),
            "--checkpoint_iterations", str(CLI_CKPT),
            "--test_iterations", str(CLI_ITERS),
            "--densify_from_iter", str(CLI_DENSIFY),
            "--densification_interval", str(CLI_DENSIFY),
            "--data_parallel", "1", "--k_cap", str(k_cap), *extra]


def cli_probe(root: Path, dev) -> dict:
    """What a user sizes --k_cap by: the scene read through the loaders,
    the normal init, and the largest need of a training view with its
    boxes. Times the readers, the knn scales and `Scene`."""
    from vegs_torch import gaussians
    from vegs_torch.config import parse_config
    from vegs_torch.render import BoxInstance
    from vegs_torch.scene import Scene, box_matrix
    from vegs_torch.scene.dataset_readers import sceneLoadTypeCallbacks
    from vegs_torch.train import Trainer

    cfg = parse_config(cli_argv(root, root.parent / "probe", 1 << 20))
    t = {"readers": [], "knn": [], "scene": []}
    with Observe() as ob:
        ob.timer(sceneLoadTypeCallbacks, "KITTI360", t["readers"])
        ob.timer(gaussians, "knn_mean_sq_dist", t["knn"])
        t0 = time.perf_counter()
        scene = Scene(cfg.model, cfg.data, cfg.box, device=dev)
        torch.cuda.synchronize()
        t["scene"].append(time.perf_counter() - t0)
    trainer = Trainer(cfg, scene, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_init = trainer.init_from_normals()
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3

    def boxes_of(cam):
        bx = scene.train_bboxes.get(cam.frame, {})
        return [BoxInstance(scene.box_gaussians[g], torch.from_numpy(
            box_matrix(m).astype(np.float32)).to(dev))
            for g, m in bx.items() if g in scene.box_gaussians][:8]

    with torch.inference_mode():
        _, need_raw, need_pad = sized_config(
            trainer.state.field, scene.getTrainCameras(), dev, boxes_of,
            BOX_PROBE_CAP)
    n_points = int(scene.gaussians.num_active())
    boxes_per_frame = sorted({len(boxes_of(c)) for c in scene.getTrainCameras()})
    return {"readers_s": t["readers"][0], "knn_s": t["knn"][0],
            "scene_s": t["scene"][0], "norm_init_ms": init_ms,
            "norm_init_count": n_init, "points": n_points,
            "box_fields": len(scene.box_gaussians),
            "boxes_per_frame": boxes_per_frame,
            "train_cameras": len(scene.getTrainCameras()),
            "test_cameras": len(scene.getTestCameras()),
            "need_raw": need_raw, "need_pad": need_pad,
            "k_cap": r512(need_raw * CLI_KCAP_MARGIN)}


def _trees_equal(a, b) -> tuple:
    """(equal, leaves compared) of two checkpoint trees, to the bit."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return False, 0
        res = [_trees_equal(a[k], b[k]) for k in a]
        return all(r[0] for r in res), sum(r[1] for r in res)
    return bool(a.dtype == b.dtype and torch.equal(a, b)), 1


def cli_run(argv: list, counters: dict) -> tuple:
    """One `vegs_torch.train.main(argv)` run on the card, observed from
    outside: each step's ms (synchronized, the lazy PNG/npy read inside),
    its K1-K4 launches and frame reads, the load and init times, the
    report's, the checkpoint's save or load (and the restored state against
    the file, to the bit). The launch counters are set to 0 just before
    `main` and read just after. Returns (Trainer, record)."""
    from vegs_torch import gaussians, train
    from vegs_torch.scene import cameras
    from vegs_torch.scene.dataset_readers import sceneLoadTypeCallbacks

    rec = {"steps": [], "readers_s": [], "knn_s": [], "scene_s": [],
           "norm_init_s": [], "report": [], "checkpoint_save": [],
           "checkpoint_load": [], "frame_read_s": []}

    def step_factory(orig):
        def step(self, it, camera=None):
            before = {k: c.launches for k, c in counters.items()}
            r0 = len(rec["frame_read_s"])
            t0 = time.perf_counter()
            m = orig(self, it, camera)
            torch.cuda.synchronize()
            rec["steps"].append({
                "it": it, "ms": (time.perf_counter() - t0) * 1e3,
                "loss": m["loss"], "num_dropped": m["num_dropped"],
                "num_needed_raw": m["num_needed_raw"],
                "k_cap": self.raster_cfg.k_cap,
                "densify": (it % self.cfg.opt.densification_interval == 0
                            and it > self.cfg.opt.densify_from_iter),
                "n_active": int(self.state.field.num_active()),
                "frame_reads": len(rec["frame_read_s"]) - r0,
                "launches": {k: c.launches - before[k]
                             for k, c in counters.items()}})
            return m
        return step

    def report_factory(orig):
        def report(self, it, out_dir=None):
            before = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = orig(self, it, out_dir)
            torch.cuda.synchronize()
            rec["report"].append({
                "it": it, "s": time.perf_counter() - t0, "result": r,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": {k: c.launches - before[k]
                             for k, c in counters.items()},
                "pngs": sorted(p.name for p in (Path(out_dir)
                                                / f"iter_{it}").iterdir())})
            return r
        return report

    def save_factory(orig):
        def save(self, it):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(self, it)
            rec["checkpoint_save"].append({
                "it": it, "s": time.perf_counter() - t0,
                "bytes": self.checkpoint_path(it).stat().st_size})
        return save

    def load_factory(orig):
        def load(self, it):
            t0 = time.perf_counter()
            orig(self, it)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            saved = torch.load(self.checkpoint_path(it), map_location="cpu",
                               weights_only=True)
            equal, leaves = _trees_equal(self._checkpoint_tree(), saved)
            rec["checkpoint_load"].append({
                "it": it, "s": s, "bytes": self.checkpoint_path(it).stat().st_size,
                "restored_equal": equal, "leaves": leaves,
                "step": int(self.state.step)})
        return load

    stdout = sys.stdout
    with Observe() as ob:
        ob.wrap(train.Trainer, "train_iteration", step_factory)
        ob.wrap(train.Trainer, "training_report", report_factory)
        ob.wrap(train.Trainer, "save_checkpoint", save_factory)
        ob.wrap(train.Trainer, "load_checkpoint", load_factory)
        ob.timer(train.Trainer, "init_from_normals", rec["norm_init_s"],
                 sync=True)
        ob.timer(sceneLoadTypeCallbacks, "KITTI360", rec["readers_s"])
        ob.timer(gaussians, "knn_mean_sq_dist", rec["knn_s"])
        ob.timer(train, "Scene", rec["scene_s"], sync=True)
        ob.timer(cameras, "_load_image", rec["frame_read_s"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        try:
            trainer = train.main(argv)
        finally:
            sys.stdout = stdout   # main's safe_state timestamps stdout
        torch.cuda.synchronize()
        rec["main_s"] = time.perf_counter() - t0
        rec["launches"] = {k: c.launches for k, c in counters.items()}
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return trainer, rec


def check_cli_run(name: str, trainer, rec: dict, first_it: int) -> dict:
    """The run's steps: K1-K4 in every step, K2 and K3 exactly once, the
    ground truth read from its PNG, finite losses; then its final
    PLYs (the static field and every instance) loaded back through
    `Scene(load_iteration=-1)` with finite values. Returns the summary."""
    from vegs_torch.scene import Scene

    steps = rec["steps"]
    its = [s_["it"] for s_ in steps]
    if its != list(range(first_it, CLI_ITERS + 1)):
        raise AssertionError(f"run {name} trained iterations {its}")
    for s_ in steps:
        ln = s_["launches"]
        if min(ln.values()) < 1 or ln["K2"] != 1 or ln["K3"] != 1:
            raise AssertionError(f"run {name} step {s_['it']} launches {ln}")
        if s_["frame_reads"] != 1:
            raise AssertionError(f"run {name} step {s_['it']} read "
                                 f"{s_['frame_reads']} frames")
    losses = [s_["loss"] for s_ in steps]
    if not np.isfinite(losses).all():
        raise AssertionError(f"run {name} losses {losses}")
    back = Scene(trainer.cfg.model, scene_info=trainer.scene.scene_info,
                 load_iteration=-1, shuffle=False, device=trainer.device)
    if back.loaded_iter != CLI_ITERS or len(back.box_gaussians) != len(
            trainer.box_fields):
        raise AssertionError(f"run {name} saved iteration {back.loaded_iter}, "
                             f"{len(back.box_gaussians)} instances")
    for f in [back.gaussians, *back.box_gaussians.values()]:
        for k in ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                  "opacity_logit"):
            if not torch.isfinite(getattr(f, k)).all():
                raise AssertionError(f"run {name}: PLY {k} not finite")
    plain = [s_["ms"] for s_ in steps[1:] if not s_["densify"]]
    return {"iterations": [its[0], its[-1]], "loss": losses,
            "ms_per_step": float(np.median(plain)),
            "png_read_ms": float(np.median(rec["frame_read_s"])) * 1e3,
            "ms_steps": [s_["ms"] for s_ in steps],
            "densify_step_ms": {s_["it"]: s_["ms"] for s_ in steps
                                if s_["densify"]},
            "k_cap": [steps[0]["k_cap"], steps[-1]["k_cap"]],
            "num_dropped": [s_["num_dropped"] for s_ in steps],
            "num_needed_raw": [s_["num_needed_raw"] for s_ in steps],
            "n_active": [steps[0]["n_active"], steps[-1]["n_active"]],
            "launches": rec["launches"], "main_s": rec["main_s"],
            "readers_s": rec["readers_s"], "knn_s": rec["knn_s"],
            "scene_s": rec["scene_s"],
            "norm_init_ms": [x * 1e3 for x in rec["norm_init_s"]],
            "report": [{k: v for k, v in r.items()} for r in rec["report"]],
            "checkpoint_save": rec["checkpoint_save"],
            "checkpoint_load": rec["checkpoint_load"],
            "max_memory_allocated": rec["max_memory_allocated"],
            "ply_instances": len(back.box_gaussians),
            "ply_points": int(back.gaussians.num_active())}


def cli_frame_read(trainer) -> dict:
    """The host's read of a training frame and its normal map (the lazy
    load inside each CLI step), on run B's Trainer after its run."""
    cams = trainer.scene.getTrainCameras()[:3]
    t0 = time.perf_counter()
    for cam in cams:
        np.asarray(cam.original_image, np.float32)
        cam.world_normal()
    return {"frame_read_ms": (time.perf_counter() - t0) * 1e3 / len(cams),
            "frames": len(cams)}


def cli_phase(dev, card, tmp: Path) -> dict:
    """The training CLI from a KITTI-360 segment on disk (see phase 11),
    written under `tmp`; the segment and the model directory stay there for
    the tools phase."""
    from vegs_torch.config import VegsConfig

    counters = main_counters()
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    root = tmp / "kitti360"
    t0 = time.perf_counter()
    seg = write_cli_segment(root, dev)
    torch.cuda.empty_cache()
    seg["write_s"] = time.perf_counter() - t0
    pngs = png_check(seg.pop("images"))
    emit("cli_segment", card=card, **seg)
    emit("cli_png", card=card, **pngs)
    os.chdir(tmp)   # the readers write their point cache to ./.cache
    try:
        probe = cli_probe(root, dev)
        torch.cuda.empty_cache()
        emit("cli_probe", card=card, **probe)
        model = tmp / "model"
        argv = cli_argv(root, model, probe["k_cap"])
        trainer, rec_a = cli_run(argv, counters)
        run_a = check_cli_run("A", trainer, rec_a, 1)
        if not rec_a["checkpoint_save"] or rec_a["checkpoint_load"]:
            raise AssertionError("run A: one checkpoint saved, none loaded")
        rep = rec_a["report"]
        if len(rep) != 1 or len(rep[0]["pngs"]) != 8:
            raise AssertionError(f"run A's report: {rep}")
        VegsConfig.load(model / "cfg_args.json")
        del trainer
        torch.cuda.empty_cache()
        emit("cli_run", run="A", card=card, **run_a)

        trainer, rec_b = cli_run(
            argv + ["--start_checkpoint", str(CLI_CKPT)], counters)
        run_b = check_cli_run("B", trainer, rec_b, CLI_CKPT + 1)
        ld = rec_b["checkpoint_load"]
        if (len(ld) != 1 or not ld[0]["restored_equal"]
                or ld[0]["step"] != CLI_CKPT):
            raise AssertionError(f"run B's restore: {ld}")
        emit("cli_frame_read", card=card, **cli_frame_read(trainer))
        del trainer
        torch.cuda.empty_cache()
        emit("cli_run", run="B", card=card, **run_b)
    finally:
        os.chdir(cwd)
    launches = {k: run_a["launches"][k] + run_b["launches"][k]
                for k in run_a["launches"]}
    emit("cli", card=card, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return {"probe": probe, "png": pngs, "A": run_a, "B": run_b,
            "launches": launches, "root": root, "model": model, "argv": argv}


# The tools phase: the offline tools around a training run, on the cli
# phase's segment and trained model directory.
TOOLS_LORA_IMAGES, TOOLS_LORA_SIZE = 16, 512
TOOLS_LORA_STEPS, TOOLS_LORA_ACCUM = 3, 4
TOOLS_VIDEO_FRAMES = 8             # interpolated cameras a trajectory (of 53)
# the DPT crop, card against CPU, both in float32: the largest |d| of the
# unit normals, scaled by the length of the decoded vector each normalizes
# where that is under 1 (tests/test_torch_dpt.py); control: the card's
# readout with the cls half of its projection zeroed
DPT_CROP_LIMIT = 1e-3
METRICS_TOL = 1e-5                 # SSIM / PSNR, card against CPU


def all_counters() -> dict:
    """K1-K4's and M1's and M2's launch counters
    (`vegs_torch.perf.all_counters`)."""
    from vegs_torch import perf

    return perf.all_counters()


def dpt_crop_check(est, crop_rgb) -> dict:
    """One 384x384 crop through the DPT on the card and on the CPU (the
    same weights, float32 on both), and the control: the card's readout
    projections with the weight columns that read the cls token zeroed."""
    import cv2

    from vegs_torch.priors.dpt import dpt_from_state

    s = est.cfg.image_size
    x = cv2.resize(crop_rgb, (s, s), interpolation=cv2.INTER_AREA)
    x = torch.from_numpy((x - 0.5) / 0.5).permute(2, 0, 1)[None]
    cpu = dpt_from_state({k: v.cpu() for k, v in est.model.state_dict().items()},
                         est.cfg, "cpu")
    heads = {}
    cpu.head_out.register_forward_hook(
        lambda m, i, o: heads.__setitem__("out", o))
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu(x)
    cpu_s = time.perf_counter() - t0
    out = torch.clamp(heads["out"], 0, 1)
    length = torch.linalg.vector_norm((out - 0.5) * 2, dim=1, keepdim=True)

    def reading(n_card):
        d = (n_card.cpu() - want).abs() * torch.clamp(length, max=1.0)
        return float(d.max())

    with torch.inference_mode():
        got = est.model(x.to(est.device))
        sound = reading(got)
        d = est.cfg.embed_dim
        saved = [(lin, lin.weight[:, d:].clone())
                 for lin in (est.model.post3_readout, est.model.post4_readout)]
        for lin, _ in saved:
            lin.weight[:, d:] = 0
        control = reading(est.model(x.to(est.device)))
        for lin, w in saved:
            lin.weight[:, d:] = w
    return {"reading": sound, "control_reading": control,
            "limit": DPT_CROP_LIMIT, "cpu_s": cpu_s,
            "min_length": float(length.min()),
            "normals_std": float(want.std(dim=(2, 3)).mean())}


def normal_estimation(dev, card, root: Path) -> dict:
    """The DPT at published width (readout "project", random weights from
    seed 0) over the segment's frames, both cameras, sliding mode; the
    written maps read back through the KITTI-360 reader; one crop on the
    card against the CPU."""
    from PIL import Image

    from vegs_torch.priors.dpt import DPTConfig
    from vegs_torch.scene.dataset_readers import (camera_from_info,
                                                  readKITTI360Cameras)
    from vegs_torch.tools.estimate_normal import (NormalEstimator,
                                                  estimate_sequence)

    torch.backends.cudnn.allow_tf32 = True     # PyTorch's default
    t0 = time.perf_counter()
    est = NormalEstimator(DPTConfig(), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in est.model.parameters())
    frame = (root / "data_2d_raw" / CLI_SEQ / "image_00" / "data_rect"
             / f"{CLI_START:010d}.png")
    img = np.asarray(Image.open(frame), np.float32) / 255.0
    est.infer_sliding(img)                  # warm-up (cuDNN's choices)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = estimate_sequence(root, CLI_SEQ, est, cam_ids=(0, 1))
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if n != 2 * CLI_FRAMES:
        raise AssertionError(f"estimate_sequence wrote {n} maps")
    # the model alone on one frame's 7 crops
    side = img.shape[0]
    crops = [img[:, x0:x0 + side] for x0 in
             sorted(set(list(range(0, W - side + 1, side // 2)) + [W - side]))]
    t0 = time.perf_counter()
    est.infer_batch(crops)
    torch.cuda.synchronize()
    crops_ms = (time.perf_counter() - t0) * 1e3
    # the written maps through the reader
    norms = []
    for info in readKITTI360Cameras(str(root), CLI_SEQ, CLI_START,
                                    CLI_START + CLI_FRAMES):
        nm = camera_from_info(info).original_normal
        if nm.shape != (3, H, W) or not np.isfinite(nm).all():
            raise AssertionError(f"{info.normal_path}: {nm.shape}")
        norms.append(float(np.abs(np.linalg.norm(nm, axis=0) - 1).max()))
    if max(norms) > 1e-5:
        raise AssertionError(f"normal maps off unit length by {max(norms)}")
    torch.backends.cudnn.allow_tf32 = False
    crop = dpt_crop_check(est, img[:, :side])
    hold("DPT crop, card against CPU", crop["reading"], DPT_CROP_LIMIT,
         crop["control_reading"])
    res = {"frames": n, "crops_per_frame": len(crops), "params": n_params,
           "init_s": init_s, "ms_per_frame": seq_s / n * 1e3,
           "model_ms_per_frame": crops_ms, "max_memory_allocated": peak,
           "unit_norm_max_err": max(norms), "crop_check": crop}
    del est
    torch.cuda.empty_cache()
    emit("tools_normals", card=card, readout="project", **res)
    return res


def lora_finetune(dev, card, root: Path, tmp: Path) -> dict:
    """16 crops at 512 cut from the segment, then SD-2.1's LoRA fine-tuned
    on them at full width (3 steps x grad-accum 4); the saved file loaded
    into a fresh UNet equals the trained leaves, to the bit."""
    from vegs_torch.diffusion.lora import is_lora_path, load_lora_weights
    from vegs_torch.diffusion.unet import init_unet
    from vegs_torch.tools import lora_preprocess, lora_train

    t0 = time.perf_counter()
    data = lora_preprocess.preprocess_segment(
        root, CLI_SEQ, CLI_START, CLI_START + CLI_FRAMES, tmp / "lora_data",
        n_images=TOOLS_LORA_IMAGES, size=TOOLS_LORA_SIZE, seed=SEED)
    prep_s = time.perf_counter() - t0
    images = lora_train.load_segment_images(data, size=TOOLS_LORA_SIZE)
    models = sd_models(dev)
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's default
    start = {n: p.detach().clone() for n, p in models.unet.named_parameters()
             if is_lora_path(n)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]

    def on_step(i, loss):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    out_dir = tmp / "lora_models" / CLI_SEQ / f"{CLI_START}_{CLI_START + CLI_FRAMES}"
    losses = lora_train.train_segment(
        models, images, str(out_dir), steps=TOOLS_LORA_STEPS, seed=SEED,
        grad_accum=TOOLS_LORA_ACCUM, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    torch.backends.cudnn.allow_tf32 = False
    ms = [(b - a) * 1e3 for a, b in zip(marks[:-1], marks[1:])]
    if len(losses) != TOOLS_LORA_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"LoRA losses {losses}")
    trained = {n: p.detach().clone() for n, p in models.unet.named_parameters()
               if is_lora_path(n)}
    moved = sum(not torch.equal(trained[n], start[n]) for n in trained)
    if moved != len(trained):
        raise AssertionError(f"{len(trained) - moved} LoRA leaves unchanged")
    ucfg = models.unet.config
    del models
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    fresh = load_lora_weights(init_unet(g, ucfg), out_dir)
    unequal = [n for n, p in fresh.named_parameters()
               if n in trained and not torch.equal(p, trained[n])]
    if unequal:
        raise AssertionError(f"lora_weights.pkl does not restore {unequal[:4]}")
    res = {"crops": TOOLS_LORA_IMAGES, "size": TOOLS_LORA_SIZE,
           "preprocess_s": prep_s, "steps": TOOLS_LORA_STEPS,
           "grad_accum": TOOLS_LORA_ACCUM, "loss": losses, "ms_steps": ms,
           "ms_per_update": float(np.median(ms[1:])),
           "max_memory_allocated": peak, "lora_leaves": len(trained),
           "lora_params": sum(p.numel() for p in trained.values()),
           "file_bytes": (out_dir / "lora_weights.pkl").stat().st_size,
           "reloaded_equal": True}
    del fresh, trained, start
    torch.cuda.empty_cache()
    emit("tools_lora", card=card, **res)
    return res


def video_views(scene, max_frames):
    """The views and boxes `render_frames` renders: the interpolated left
    cameras at each default trajectory, with the interpolated box poses."""
    import vegs_torch.render_video as rv
    from vegs_torch.render import BoxInstance
    from vegs_torch.scene.cameras import make_camera_like_input_camera

    cams = sorted(scene.getTrainCameras(), key=lambda c: (c.frame, c.colmap_id))
    left = [c for c in cams if getattr(c, "cam_idx", 0) == 0] or cams
    interp = rv.interpolate_cameras(left, 4)[:max_frames]
    timeline = rv.interpolate_bboxes(scene.train_bboxes,
                                     [c.frame for c in left], 4)[:max_frames]
    views = []
    for aug in rv.DEFAULT_AUG_PARAMS:
        for cam, boxes in zip(interp, timeline):
            views.append((make_camera_like_input_camera(cam, **aug), [
                BoxInstance(scene.box_gaussians[g], torch.from_numpy(
                    m.astype(np.float32)).to(scene.device))
                for g, m in boxes.items() if g in scene.box_gaussians]))
    return views


def render_videos(dev, card, cli: dict) -> dict:
    """`render_video.render_sets` on the cli phase's config at its last
    iteration: interpolated cameras and box poses, the 4 default
    trajectories, TOOLS_VIDEO_FRAMES a trajectory; the launch counters set
    to 0 just before and read just after; each mp4 read back."""
    import cv2

    import vegs_torch.render_video as rv
    from vegs_torch.config import parse_config
    from vegs_torch.scene import Scene

    cfg = parse_config(cli["argv"])
    scene = Scene(cfg.model, cfg.data, cfg.box, load_iteration=-1,
                  shuffle=False, device=dev)
    views = video_views(scene, TOOLS_VIDEO_FRAMES)
    boxes_of = {id(v): b for v, b in views}
    with torch.inference_mode():
        raster, need_raw, need_pad = sized_config(
            scene.gaussians, [v for v, _ in views], dev,
            lambda v: boxes_of[id(v)], BOX_PROBE_CAP)
    boxes_per_view = sorted({len(b) for _, b in views})
    if not max(boxes_per_view):
        raise AssertionError("no box in the views the videos render")
    del scene, views
    torch.cuda.empty_cache()
    counters = all_counters()
    rec = {"ms": [], "dropped": 0}

    def timed(orig):
        def render_image(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = orig(*a, **kw)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            return img
        return render_image

    def dropped(orig):
        def render_view(*a, **kw):
            out = orig(*a, **kw)
            rec["dropped"] += int(out.num_dropped)
            return out
        return render_view

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Observe() as ob:
        ob.wrap(rv, "render_novelview_image", timed)
        ob.wrap(rv, "_render_view", dropped)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        outputs = rv.render_sets(cfg, device=dev, raster_cfg=raster,
                                 max_frames=TOOLS_VIDEO_FRAMES)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_frames = len(rec["ms"])
    if n_frames != 4 * TOOLS_VIDEO_FRAMES or rec["dropped"]:
        raise AssertionError(f"{n_frames} frames, {rec['dropped']} dropped")
    if min(launches["K1"], launches["K4"]) < n_frames:
        raise AssertionError(f"launches {launches} for {n_frames} frames")
    read_back = {}
    for name, path in outputs.items():
        cap = cv2.VideoCapture(path)
        k = 0
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            if fr.shape != (H, W, 3):
                raise AssertionError(f"{name}: frame {fr.shape}")
            k += 1
        cap.release()
        read_back[name] = k
    if sorted(read_back.values()) != [TOOLS_VIDEO_FRAMES] * 4:
        raise AssertionError(f"videos read back {read_back}")
    res = {"videos": read_back, "frames": n_frames, "k_cap": raster.k_cap,
           "k_pad": raster.k_pad, "need_raw": need_raw, "need_pad": need_pad,
           "boxes_per_view": boxes_per_view,
           "ms_per_frame": float(np.median(rec["ms"][1:])),
           "ms_frames": rec["ms"], "render_sets_s": total_s,
           "launches": launches, "max_memory_allocated": peak}
    emit("tools_video", card=card, **res)
    return res


def write_test_renders(dev, cli: dict) -> tuple:
    """{model}/test/ours_<it>/{renders,gt}: each test camera rendered at
    the last iteration with its frame's boxes, and its ground-truth frame,
    as PNGs. Returns (model path, method)."""
    from PIL import Image

    import vegs_torch.render_video as rv
    from vegs_torch.config import parse_config
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.scene import Scene

    cfg = parse_config(cli["argv"])
    scene = Scene(cfg.model, cfg.data, cfg.box, load_iteration=-1,
                  shuffle=False, device=dev)
    method = f"ours_{scene.loaded_iter}"
    base = Path(cfg.model.model_path) / "test" / method
    for sub in ("renders", "gt"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    cams = scene.getTestCameras()
    bg = torch.zeros(3, device=dev)
    raster = RasterizeConfig(k_cap=cli["probe"]["k_cap"], forward_only=True)
    for i, cam in enumerate(cams):
        boxes = {**scene.train_bboxes.get(cam.frame, {}),
                 **scene.test_bboxes.get(cam.frame, {})}
        img = rv.render_novelview_image(scene, cam, boxes, raster, bg,
                                        rv.DEFAULT_AUG_PARAMS[0])
        for sub, a in (("renders", img),
                       ("gt", cam.original_image.transpose(1, 2, 0))):
            Image.fromarray((np.clip(a, 0, 1) * 255).round().astype(np.uint8)
                            ).save(base / sub / f"{i:05d}.png")
    return Path(cfg.model.model_path), method, len(cams)


def metrics_check(dev, card, cli: dict) -> dict:
    """`metrics.evaluate` over the test renders on the card; SSIM and PSNR
    of every view equal to the CPU's on the same PNGs within METRICS_TOL."""
    from vegs_torch import metrics

    model, method, n = write_test_renders(dev, cli)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = metrics.evaluate([str(model)], device=dev)
    card_s = time.perf_counter() - t0
    per_view = json.loads((model / "per_view.json").read_text())[method]
    d = model / "test" / method
    t0 = time.perf_counter()
    cpu = metrics.evaluate_dirs(d / "renders", d / "gt", device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {k: max(abs(per_view[k][v] - cpu["per_view"][k][v])
                   / max(1.0, abs(cpu["per_view"][k][v]))
                   for v in cpu["per_view"][k])
            for k in ("SSIM", "PSNR")}
    if len(per_view["PSNR"]) != n or n == 0:
        raise AssertionError(f"{len(per_view['PSNR'])} views of {n} scored")
    for k, e in errs.items():
        hold(f"metrics {k}, card against CPU", e, METRICS_TOL)
    out = {"views": n, "method": method, "results": res[str(model)],
           "card_s": card_s, "cpu_s": cpu_s, "max_rel_err": errs,
           "limit": METRICS_TOL, "lpips": "LPIPS" in per_view and bool(
               per_view["LPIPS"])}
    emit("tools_metrics", card=card, **out)
    return out


def tools_phase(dev, card, tmp: Path, cli: dict) -> dict:
    """The offline tools around a training run (see phase 12), on the cli
    phase's segment and model directory under `tmp`."""
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    os.chdir(tmp)   # the readers write their point cache to ./.cache
    try:
        normals = normal_estimation(dev, card, cli["root"])
        lora = lora_finetune(dev, card, cli["root"], tmp)
        video = render_videos(dev, card, cli)
        torch.cuda.empty_cache()
        mets = metrics_check(dev, card, cli)
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.allow_tf32 = False
    seconds = time.perf_counter() - t_phase
    emit("tools", card=card, launches=video["launches"], seconds=seconds)
    return {"normals": normals, "lora": lora, "video": video,
            "metrics": mets, "launches": video["launches"],
            "seconds": seconds}


# The guide phase: the diffusion-guided step at full width. The window is
# open over iterations 3001-3014: 8 score-matching steps (3001-3008), 4 SDS
# steps (3009-3012), then 2 SDS steps under the profiler (3013-3014).
GUIDE_FIRST_IT, GUIDE_SM_STEPS, GUIDE_SDS_STEPS = 3001, 8, 4
GUIDE_PROFILED = 2
GUIDE_WINDOW = (3000, 3015)        # start < it < end, and the annealing's
GUIDE_CAMS = (0, 1, 2, 0, 1, 2, 1, 0, 2, 1, 0, 2, 1, 2, 0)
SD_IMAGE_SIZE = 512                # the augmented views: 512x1917
GUIDE_GRAD_RTOL = 1e-4             # the reduced check, per field leaf
# the same with the main path's bf16 aux: one bf16 step (2^-8 to 2^-7 of a
# value) on every colour row reads 3.9e-3 or more, so 1e-3 fails such an
# error and passes rounding flips on a few rows (sound reading on an H100
# 1.18e-4; the flipped-CFG control 0.13)
GUIDE_GRAD_RTOL_BF16 = 1e-3
# VGG16's image gradient, card against CPU: set from the first sound
# reading on an H100, 1.16e-3 (a ReLU mask or a max-pool choice flips);
# control: the card's loss without its last feature layer
VGG_GRAD_RTOL = 1e-2


def sd_models(dev, seed=SEED):
    """Stable-Diffusion-2.1-base's UNet (LoRA rank 4 on every attention
    projection, fresh: up-projections zero) and the SD VAE at their
    published widths, random weights from `seed`, and random text
    embeddings [2, 77, 1024] (prompt, negative prompt)."""
    import dataclasses

    from vegs_torch.diffusion.pipeline import DiffusionModels
    from vegs_torch.diffusion.scheduler import DiffusionSchedule
    from vegs_torch.diffusion.unet import UNetConfig, init_unet
    from vegs_torch.diffusion.vae import VAEConfig, init_vae

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ucfg = dataclasses.replace(UNetConfig.sd21(), lora_rank=4)
    unet = init_unet(g, ucfg)
    vae = init_vae(g, VAEConfig.sd())
    text = torch.randn((2, 77, ucfg.cross_attention_dim), generator=g,
                       device=dev)
    return DiffusionModels(unet=unet, vae=vae,
                           schedule=DiffusionSchedule.scaled_linear(device=dev),
                           text_embeddings=text)


def guide_grad_check(dev, n=50_000, seed=SEED) -> dict:
    """One guided SDS step's gradients through the kernels on the card
    against the plain versions on the CPU, on a reduced scene: 128x512
    with 50k Gaussians, `sd_image_size` 64 (the augmented view 64x256, a
    64x64 crop), the tiny diffusion stack (its LoRA up-projections
    non-zero) carried across with `convert`, the draws replayed (on the
    step's `GuidedView`), TF32 off. The relative L2 error of each field
    leaf, and of the control: the card with the CFG orientation flipped.
    With f32 aux payloads, and with the main path's bf16 aux, each with
    its control: there each Gaussian's colour cotangent sum is rounded to
    bf16 once, and in the small augmented view most Gaussians have one or
    two instances, so a float32 difference in K2's order moves some rows
    to the neighbouring bf16 value (as the grad phase's box colour rows).
    Then VGG16's perceptual loss and its image gradient on the card
    against the CPU (random features), with the control the card's loss
    without its last feature layer."""
    import dataclasses

    from vegs_torch import convert, optim
    from vegs_torch.config import VegsConfig
    from vegs_torch.diffusion.pipeline import DiffusionModels
    from vegs_torch.gaussians import DensifyStats
    from vegs_torch.losses import vgg
    from vegs_torch.losses.perceptual import vgg_perceptual_loss
    from vegs_torch.losses.sd_guidance import SDGuidance
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.scene.cameras import augment_camera
    from vegs_torch.scene.dataset_readers import camera_from_info
    from vegs_torch.train import GuidedView, TrainState, train_step
    from vegs_torch.utils.synthetic import street_camera_infos

    h, w, size = 128, 512, 64
    cam = camera_from_info(street_camera_infos(1, h, w, fovx=1.2,
                                               fovy=0.4)[0])
    sd = VegsConfig().sd
    sd.sd_image_size = size
    aug = augment_camera(cam, sd, np.random.default_rng(seed + 19))[0]
    crop_start = (aug.image_width - aug.image_height) // 2
    arrays = convert.field_to_numpy(synthetic_field(n, seed + 13))
    g = torch.Generator()
    g.manual_seed(seed + 23)
    tiny = DiffusionModels.tiny(g, lora_rank=4)
    with torch.no_grad():
        for name, p in tiny.unet.named_parameters():
            if "lora_up" in name:
                p.normal_(0.0, 0.05, generator=g)
    trees = (convert.module_to_flax(tiny.unet),
             dataclasses.asdict(tiny.unet.config),
             convert.module_to_flax(tiny.vae),
             dataclasses.asdict(tiny.vae.config), tiny.schedule.betas.numpy(),
             tiny.schedule.alphas_cumprod.numpy(),
             tiny.text_embeddings.numpy())
    lat = (1, 4, size // 2, size // 2)
    draws = {"eps": torch.randn(lat, generator=g), "t": torch.tensor([40]),
             "noise": torch.randn(lat, generator=g)}
    gt = torch.rand((3, h, w), generator=g)
    opt = VegsConfig().opt
    grads, metrics, times = {}, {}, {}
    cpu = torch.device("cpu")
    runs = (("card", dev, True, "f32"), ("control", dev, False, "f32"),
            ("plain", cpu, True, "f32"), ("card_bf16", dev, True, "bf16"),
            ("control_bf16", dev, False, "bf16"),
            ("plain_bf16", cpu, True, "bf16"))
    for run, d, orient, aux in runs:
        guidance = SDGuidance(
            convert.diffusion_models_from_flax(*trees, device=d),
            guidance_mode="sds", start_iter=0, max_iters=100,
            reference_cfg_orientation=orient)
        field = convert.field_from_numpy(arrays, device=d)
        st = TrainState(field=field, opt=optim.adam_init(field),
                        stats=DensifyStats.zeros(field.capacity, d), step=10)
        t0 = time.perf_counter()
        _, m, _ = train_step(
            st, cam.device_params(d), gt.to(d), torch.zeros_like(gt).to(d),
            0.0, 3, torch.zeros(3, device=d), opt_cfg=opt,
            raster_cfg=RasterizeConfig(k_cap=1 << 21, k_pad=1 << 21,
                                       payload_dtype=aux),
            spatial_scale=1.0,
            guidance=GuidedView(guidance, aug.device_params(d), crop_start,
                                draws={k: v.to(d) for k, v in draws.items()}))
        if d.type == "cuda":
            torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        metrics[run] = {k: float(v) for k, v in m.items()}
        if metrics[run]["num_dropped"] or metrics[run]["aug_num_dropped"]:
            raise AssertionError(f"the guided check drops instances: {m}")
        grads[run] = {k: getattr(field, k).grad.cpu()
                      for k in optim.PARAM_LEAVES}
    errs = {"card": {}, "control": {}, "card_bf16": {}, "control_bf16": {}}
    for run in errs:
        for k, got in grads[run].items():
            ref = grads["plain_bf16" if run.endswith("bf16") else "plain"][k]
            if not torch.isfinite(got).all() or float(ref.norm()) == 0:
                raise AssertionError(f"guided gradient {k}: not finite or 0")
            errs[run][k] = float((got - ref).norm() / ref.norm())

    # VGG16's perceptual term, card against CPU, on the plain run's render
    feats = vgg.init_params(torch.Generator().manual_seed(seed + 29))
    pred = torch.rand((3, h, w), generator=g)
    vgg_res = {}
    for run, d, layers in (("card", dev, (0, 1, 2, 3)),
                           ("control", dev, (0, 1, 2)),
                           ("plain", cpu, (0, 1, 2, 3))):
        model = convert.vgg_from_flax(convert.module_to_flax(feats), device=d)
        x = pred.to(d, copy=True).requires_grad_(True)
        loss = vgg_perceptual_loss(model, x, gt.to(d), feature_layers=layers)
        loss.backward()
        vgg_res[run] = (float(loss.detach()), x.grad.cpu())
    vgg_loss_err = abs(vgg_res["card"][0] / vgg_res["plain"][0] - 1)
    vgg_grad_err, vgg_ctl_err = (
        float((vgg_res[run][1] - vgg_res["plain"][1]).norm()
              / vgg_res["plain"][1].norm()) for run in ("card", "control"))
    return {"scene": f"{h}x{w}, {n} Gaussians; augmented view "
                     f"{aug.image_height}x{aug.image_width}, crop from "
                     f"column {crop_start}; tiny diffusion stack, LoRA 4; "
                     "SDS, t = 40; TF32 off; f32 aux, then bf16 aux",
            "rel_l2_err": errs["card"], "reading": max(errs["card"].values()),
            "bf16_aux_rel_l2_err": errs["card_bf16"],
            "bf16_aux_reading": max(errs["card_bf16"].values()),
            "bf16_aux_control_rel_l2_err": errs["control_bf16"],
            "bf16_aux_control_reading": max(errs["control_bf16"].values()),
            "control": "the card's CFG orientation flipped",
            "control_rel_l2_err": errs["control"],
            "control_reading": max(errs["control"].values()),
            "guidance_loss": {r: m["guidance_loss"] for r, m in metrics.items()},
            "loss": {r: m["loss"] for r, m in metrics.items()},
            "vgg_loss_rel_err": vgg_loss_err, "vgg_grad_rel_l2_err": vgg_grad_err,
            "vgg_control": "the card's loss without its last feature layer",
            "vgg_control_grad_rel_l2_err": vgg_ctl_err,
            "card_s": times["card"], "plain_cpu_s": times["plain"]}


def guide_phase(dev, card) -> dict:
    """The diffusion-guided training step at full width (see phase 13)."""
    from vegs_torch import optim
    from vegs_torch.config import ModelParams, VegsConfig
    from vegs_torch.losses.sd_guidance import build_guidance
    from vegs_torch.render import render
    from vegs_torch.scene import Scene
    from vegs_torch.scene.dataset_readers import SceneInfo, getNerfppNorm
    from vegs_torch.train import Trainer, guidance_loss
    from vegs_torch.utils.synthetic import street_camera_infos, unit_normal_map

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as model_dir:
        write_field_ply(Path(model_dir) / "point_cloud" / "iteration_1"
                        / "point_cloud.ply", N_REF, SEED)
        infos = street_camera_infos(3, H, W, fovx=1.2, fovy=0.4)
        info = SceneInfo(point_cloud=None, train_cameras=infos, test_cameras=[],
                         nerf_normalization=getNerfppNorm(infos), ply_path="")
        scene = Scene(ModelParams(model_path=model_dir), scene_info=info,
                      load_iteration=-1, shuffle=False, device=dev)
    cams = scene.getTrainCameras()
    with torch.inference_mode():
        cfg_train, need_raw, need_pad = sized_config(
            scene.gaussians, cams, dev, probe_cap=BOX_PROBE_CAP)
        for i, cam in enumerate(cams):  # ground truth: the unperturbed field
            out = render(cam, scene.gaussians,
                         config=cfg_train._replace(forward_only=True))
            cam.image = torch.clamp(out.rgb, 0, 1).cpu().numpy()
            cam.normal = unit_normal_map(H, W, seed=i)
    with torch.no_grad():
        scene.gaussians.sh_dc += 0.35
    t_models = time.perf_counter()
    models = sd_models(dev)
    torch.cuda.synchronize()
    models_s = time.perf_counter() - t_models
    n_unet = sum(p.numel() for p in models.unet.parameters())
    n_lora = sum(p.numel() for k, p in models.unet.named_parameters()
                 if "lora_" in k)
    n_vae = sum(p.numel() for p in models.vae.parameters())
    tcfg = VegsConfig()
    tcfg.sd.sd_image_size = SD_IMAGE_SIZE
    tcfg.sd.perceptual_loss = True
    tcfg.sd.start_guiding_from_iter, tcfg.sd.end_guiding_at_iter = GUIDE_WINDOW
    guidance = build_guidance(tcfg.sd, models=models,
                              max_iters=GUIDE_WINDOW[1])
    trainer = Trainer(tcfg, scene, raster_cfg=cfg_train, device=dev,
                      sd_guidance=guidance)
    # the step counter a run reaching iteration 3001 has (the guidance
    # anneals its timestep by it, as the JAX step does)
    trainer.state.step = GUIDE_FIRST_IT - 1
    n_vgg = sum(p.numel() for p in trainer._vgg.parameters())
    # the augmented views the steps will draw (the Trainer's rng, replayed
    # on a copy): capacities for the training and the augmented views
    import copy

    rng = copy.deepcopy(trainer.rng)
    views = [trainer._step_extras(GUIDE_FIRST_IT, cams[ci])[0]
             for ci in GUIDE_CAMS]
    trainer.rng = rng
    n_steps = GUIDE_SM_STEPS + GUIDE_SDS_STEPS
    its = range(GUIDE_FIRST_IT, GUIDE_FIRST_IT + n_steps + GUIDE_PROFILED)
    with torch.inference_mode():
        cfg_aug, aug_raw, aug_pad = sized_config(
            scene.gaussians, [v.cam for v in views], dev,
            probe_cap=BOX_PROBE_CAP)
    cfg = cfg_train._replace(k_cap=max(cfg_train.k_cap, cfg_aug.k_cap),
                             k_pad=max(cfg_train.k_pad, cfg_aug.k_pad))
    trainer.raster_cfg = cfg
    aug_hw = (views[0].cam.height, views[0].cam.width)
    setup_s = time.perf_counter() - t0
    emit("guide_setup", card=card, n=N_REF, aug_view=list(aug_hw),
         unet_parameters=n_unet, unet_lora_parameters=n_lora,
         vae_parameters=n_vae, vgg16_parameters=n_vgg,
         text_embeddings=list(models.text_embeddings.shape),
         models_init_s=models_s, k_cap=cfg.k_cap, k_pad=cfg.k_pad,
         need_raw_train=need_raw, need_pad_train=need_pad,
         need_raw_aug=aug_raw, need_pad_aug=aug_pad,
         crop_starts=[v.crop_start for v in views], setup_s=setup_s)

    # the guided steps, with PyTorch's default TF32 settings (as `main`
    # runs): cuDNN convolutions in TF32, matmuls in full float32
    tf32 = {"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": True}
    torch.backends.cuda.matmul.allow_tf32 = tf32["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = tf32["cudnn.allow_tf32"]
    from vegs_torch.perf import micro3

    counters = main_counters()
    off_path = {"M1": micro3.psum_consume, "M2": micro3.transpose}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (*counters.values(), *off_path.values()):
        c.launches = 0
    steps = []
    for j, (it, ci) in enumerate(zip(its[:n_steps], GUIDE_CAMS)):
        guidance.guidance_mode = "score-matching" if j < GUIDE_SM_STEPS else "sds"
        before = {k: c.launches for k, c in counters.items()}
        t1 = time.perf_counter()
        m = trainer.train_iteration(it, camera=cams[ci])
        torch.cuda.synchronize()
        steps.append({"it": it, "cam": ci, "mode": guidance.guidance_mode,
                      "ms": (time.perf_counter() - t1) * 1e3,
                      "launches": {k: c.launches - before[k]
                                   for k, c in counters.items()}, **m})
    launches = {k: c.launches
                for k, c in {**counters, **off_path}.items()}
    if any(launches[k] for k in off_path):
        raise AssertionError(f"the guided steps launched M1 or M2: {launches}")
    peak = torch.cuda.max_memory_allocated()
    for st in steps:
        if any(v != 2 for v in st["launches"].values()):
            raise AssertionError(f"a guided step did not launch each kernel "
                                 f"twice: {st}")
        vals = [st[k] for k in ("loss", "l1", "guidance_loss",
                                "perceptual_loss")]
        if not np.isfinite(vals).all():
            raise AssertionError(f"a guided step's losses: {st}")
        if st["num_dropped"] or st["aug_num_dropped"]:
            raise AssertionError(f"a guided step dropped instances: {st}")
    sm = [st["ms"] for st in steps if st["mode"] == "score-matching"]
    sds = [st["ms"] for st in steps if st["mode"] == "sds"]
    res = {"steps": n_steps, "first_it": GUIDE_FIRST_IT, "tf32": tf32,
           "ms_per_guided_step": float(np.median(sm[1:])),
           "ms_per_sds_step": float(np.median(sds[1:])),
           "ms_steps": [st["ms"] for st in steps],
           "loss": [st["loss"] for st in steps],
           "guidance_loss": [st["guidance_loss"] for st in steps],
           "perceptual_loss": [st["perceptual_loss"] for st in steps],
           "aug_need_raw": [st["aug_num_needed_raw"] for st in steps],
           "aug_need_pad": [st["aug_num_needed"] for st in steps],
           "aug_dropped": [st["aug_num_dropped"] for st in steps],
           "max_memory_allocated": peak, "launches": launches}
    emit("guide", card=card, **res)

    after = []

    def two_steps():
        for it, ci in zip(its[n_steps:], GUIDE_CAMS[n_steps:]):
            after.append(trainer.train_iteration(it, camera=cams[ci]))

    prof = profile_frames(two_steps, by_scope=True)
    if any(m["num_dropped"] or m["aug_num_dropped"]
           or not np.isfinite(m["loss"]) for m in after):
        raise AssertionError(f"profiled guided steps: {after}")
    emit("guide_profile", card=card, steps=GUIDE_PROFILED, mode="sds",
         tf32=tf32, **prof)
    torch.backends.cudnn.allow_tf32 = False  # the checks run without TF32

    # the guidance gradient alone, on the next augmented view
    guided = trainer._step_extras(GUIDE_FIRST_IT, cams[GUIDE_CAMS[-1]])[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    sds_only = build_guidance(tcfg.sd, models=models,
                              max_iters=GUIDE_WINDOW[1])
    sds_only.guidance_mode = "sds"
    field = trainer.state.field
    g_loss, aug = guidance_loss(field, guided._replace(guidance=sds_only,
                                                       generator=gen),
                                trainer.state.step, 3, trainer.bg,
                                raster_cfg=cfg, sh_total_degree=3)
    leaves = [getattr(field, k) for k in optim.PARAM_LEAVES]
    grads = torch.autograd.grad(g_loss, leaves)
    rows = torch.zeros(field.capacity, dtype=torch.bool, device=dev)
    for gr in grads:
        if not torch.isfinite(gr).all():
            raise AssertionError("the guidance gradient is not finite")
        rows |= (gr.reshape(field.capacity, -1) != 0).any(dim=1)
    unseen = aug.radii == 0
    grad_alone = {"loss": float(g_loss.detach()), "rows_with_gradient": int(rows.sum()),
                  "rows_unseen": int(unseen.sum()),
                  "unseen_rows_with_gradient": int((rows & unseen).sum()),
                  "aug_dropped": int(aug.num_dropped)}
    emit("guide_grad_alone", card=card, **grad_alone)
    if not grad_alone["rows_with_gradient"] or grad_alone["aug_dropped"]:
        raise AssertionError(f"the guidance gradient alone: {grad_alone}")
    if grad_alone["unseen_rows_with_gradient"]:
        raise AssertionError(f"gradient on rows the augmented view does not "
                             f"see: {grad_alone}")
    del grads, g_loss

    # K1 and K4 at 512x1917 against their plain versions
    with torch.inference_mode():
        st = field_stage(field, guided.cam, cfg._replace(forward_only=True))
        k4_aug = compare_k4(st)
        emit("k4_check", scene=f"{aug_hw[0]}x{aug_hw[1]} augmented view, "
             f"{N_REF:,} Gaussians", card=card, **k4_aug)
        k1_aug = compare_k1(st)
        emit("k1_check", scene=f"{aug_hw[0]}x{aug_hw[1]} augmented view, "
             f"{N_REF:,} Gaussians", aux="bf16", card=card, **k1_aug)
    del st

    # K2 and K3 on the backward of that view's guidance loss
    gen.manual_seed(SEED + 31)
    k2_args, k3_args, st = aug_kernel_inputs(
        field, guided._replace(guidance=sds_only, generator=gen),
        trainer.state.step, 3, trainer.bg, cfg)
    scene_aug = (f"{aug_hw[0]}x{aug_hw[1]} augmented view, {N_REF:,} "
                 "Gaussians, the guidance loss's backward")
    k2_aug = compare_k2(k2_args)
    emit("k2_check", scene=scene_aug, aux=str(k2_args[1].dtype), card=card,
         limit=K2_RTOL, held=K2_SCALE, **k2_aug)
    for rows, scale in K2_SCALE.items():
        hold(f"K2 {rows} by {scale}, augmented view",
             k2_aug[rows]["reading"][scale], K2_RTOL,
             k2_aug[rows]["control_reading"][scale])
    if k2_aug["flip_tiles"] > K2_MAX_FLIP_TILES * k2_args[5].num_tiles:
        raise AssertionError(f"K2 on the augmented view: "
                             f"{k2_aug['flip_tiles']} stop-flip tiles")
    k3_aug = compare_k3_fused(k3_args, st)
    emit("k3_fused", scene=scene_aug, card=card, limit=K3_RTOL, **k3_aug)
    for rows in ("f32_rows", "aux_rows"):
        hold(f"K3 fused {rows}, augmented view", k3_aug[rows]["reading"],
             K3_RTOL, k3_aug[rows]["control_reading"])
        hold(f"K3 library {rows}, augmented view",
             k3_aug[rows]["library_reading"], K3_RTOL)
    del k2_args, k3_args, st
    del trainer, scene, models, guidance, sds_only, field, aug, views
    torch.cuda.empty_cache()

    check = guide_grad_check(dev)
    emit("guide_grad_check", card=card, limit=GUIDE_GRAD_RTOL,
         bf16_aux_limit=GUIDE_GRAD_RTOL_BF16, vgg_limit=VGG_GRAD_RTOL, **check)
    hold("guided step gradients, card against CPU", check["reading"],
         GUIDE_GRAD_RTOL, check["control_reading"])
    hold("guided step gradients, bf16 aux, card against CPU",
         check["bf16_aux_reading"], GUIDE_GRAD_RTOL_BF16,
         check["bf16_aux_control_reading"])
    hold("VGG16's image gradient, card against CPU",
         check["vgg_grad_rel_l2_err"], VGG_GRAD_RTOL,
         check["vgg_control_grad_rel_l2_err"])
    return {**res, "profile": prof, "grad_alone": grad_alone,
            "k1_aug": k1_aug, "k4_aug": k4_aug, "k2_aug": k2_aug,
            "k3_aug": k3_aug, "check": check}


# the parallel phase: D = 1 under NCCL in this process, D = 2 gloo-host ranks
PAR_ITS = (3001, 3002, 3003)  # SH degree 3; no densify or opacity reset
PAR_CAMS = (0, 1, 2)
PAR_D = 2
# the Adam first moments (0.1 x the gradient after the first step) against
# the single-device step's: relative L2 error per leaf
PAR_MU_RTOL = 1e-4


def clone_field(f):
    from vegs_torch.parallel.tp_trainer import shard_field

    return shard_field(f, 0, 1)


def mu_gap(a: dict, b: dict) -> float:
    """The largest relative L2 error over the leaves of Adam's first
    moments `a` against `b` (float64 norms)."""
    return max(float((a[k].double() - b[k].double()).norm()
                     / b[k].double().norm().clamp(min=1e-300)) for k in b)


def moments(opt) -> dict:
    return {k: v.detach().clone() for k, v in opt["mu"].items()}


def par_scene(model_dir: Path, dev, targets=None):
    """The parallel phase's scene: the seeded 2,233,571-Gaussian field (the
    PLY under model_dir, written when `targets` is None) and 3 street
    cameras at 376x1408, ground truth rendered from the unperturbed field
    with synthetic normal maps (or `targets`' images and normals), then
    sh_dc + 0.35. Returns (scene, targets)."""
    from vegs_torch.config import ModelParams
    from vegs_torch.render import render
    from vegs_torch.scene import Scene
    from vegs_torch.scene.dataset_readers import SceneInfo, getNerfppNorm
    from vegs_torch.utils.synthetic import street_camera_infos, unit_normal_map

    ply = model_dir / "point_cloud" / "iteration_1" / "point_cloud.ply"
    if targets is None:
        write_field_ply(ply, N_REF, SEED)
    infos = street_camera_infos(3, H, W, fovx=1.2, fovy=0.4)
    info = SceneInfo(point_cloud=None, train_cameras=infos, test_cameras=[],
                     nerf_normalization=getNerfppNorm(infos), ply_path="")
    scene = Scene(ModelParams(model_path=str(model_dir)), scene_info=info,
                  load_iteration=-1, shuffle=False, device=dev)
    cams = scene.getTrainCameras()
    if targets is None:
        with torch.inference_mode():
            cfg, need_raw, need_pad = sized_config(scene.gaussians, cams, dev)
            # the sharded renders run no sat cull: their padded layout's need
            nosat = cfg._replace(sat_cull=False, k_pad=PROBE_CAP,
                                 forward_only=True)
            need_nosat = max(int(field_stage(
                scene.gaussians, c.device_params(dev), nosat
            ).binned.tile_starts[-1]) for c in cams[:1])
            images = []
            for cam in cams:
                out = render(cam, scene.gaussians,
                             config=cfg._replace(forward_only=True))
                images.append(torch.clamp(out.rgb, 0, 1).cpu().numpy())
        targets = {"images": images,
                   "normals": [unit_normal_map(H, W, seed=i)
                               for i in range(len(cams))],
                   "k_cap": cfg.k_cap, "k_pad": cfg.k_pad,
                   "k_pad_nosat": r512(need_nosat * 1.05),
                   "need_raw": need_raw, "need_pad": need_pad}
    for cam, img, nm in zip(cams, targets["images"], targets["normals"]):
        cam.image, cam.normal = img, nm
    with torch.no_grad():
        scene.gaussians.sh_dc += 0.35
    return scene, targets


def par_inputs(cam, dev):
    """(CameraParams, gt, normal) of a camera on the card."""
    gt = torch.from_numpy(np.asarray(cam.original_image, np.float32)).to(dev)
    nm = torch.from_numpy(np.asarray(cam.world_normal(), np.float32)).to(dev)
    return cam.device_params(dev), gt, nm


def par_tp_steps(step, state, cams, dev):
    """PAR_ITS steps of a TP step function on PAR_CAMS: (state, ms per
    step, last metrics)."""
    f, o, s = state
    bg = torch.zeros(3, device=dev)
    ms, m = [], None
    for i, ci in enumerate(PAR_CAMS):
        camp, gt, nm = par_inputs(cams[ci], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, o, s, _, m = step(f, o, s, i, camp, gt, nm, 3, bg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if int(m["num_dropped"]):
            raise AssertionError(f"TP step {i} dropped instances: {m}")
    return (f, o, s), ms, {k: float(v) for k, v in m.items()}


def par_trainer_steps(trainer, cams, explicit=True, mid=None):
    """PAR_ITS Trainer iterations (on PAR_CAMS when `explicit`, else the
    cameras the Trainer draws); `mid` receives the moments after the
    first. Returns (ms per step, losses)."""
    ms, losses = [], []
    for it, ci in zip(PAR_ITS, PAR_CAMS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_iteration(it, camera=cams[ci] if explicit else None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
        if m["num_dropped"] or not np.isfinite(m["loss"]):
            raise AssertionError(f"iteration {it}: {m}")
        if mid is not None and it == PAR_ITS[0]:
            mid.update(moments(trainer.state.opt))
    return ms, losses


def counts(counters) -> dict:
    return {k: c.launches for k, c in counters.items()}


def par_renders(field, cam, cfg, gm, tm):
    """The gauss- and tile-sharded renders of this rank's row block of
    `field` at `cam` (cfg's k_pad sized for the padded layout without the
    sat cull): {"gauss": (rgb, depth, alpha), "tile": ...}."""
    from vegs_torch.parallel import (make_gauss_sharded_rasterize,
                                     shard_field_arrays)
    from vegs_torch.parallel.tile_sharded import make_tile_sharded_rasterize
    from vegs_torch.render import field_arrays

    bg = torch.zeros(3, device=field.means.device)
    with torch.no_grad():
        a = field_arrays(field, 3)
        g = make_gauss_sharded_rasterize(gm, cam, cfg)(
            *shard_field_arrays(gm, *a), bg)
        t = make_tile_sharded_rasterize(tm, cam, cfg)(
            *shard_field_arrays(tm, *a), bg)
    return {"gauss": g, "tile": t[:3], "tile_dropped": int(t[3])}


def equal_to(ref: dict, got) -> dict:
    return {k: bool(torch.equal(ref[k], x.to(ref[k].device)))
            for k, x in zip(("rgb", "depth", "alpha"), got)}


def par_kernel_checks(plan, cam, gt, nm, cfg, opt_cfg, comm, arrays,
                      on_ranks=(0,)):
    """K1, K2 and K3 on a tile-sharded step's inputs (`arrays`, this rank's
    `FieldArrays` rows): every rank takes the step's loss and its gradient
    at the blend's output and at the payload expansion (the reverse
    exchange needs both); each rank of `on_ranks` holds K1 and K2 against
    their plain versions on its full-grid layout (only its own tiles hold
    instances) and K3 on its `order_raw` stream, with the limits and
    controls of phases 4 and 8. K2's control (the deep instances off by
    1%) changes nothing on a rank whose tiles hold at most 256 instances,
    so it is held only where deep instances exist, and the result says
    whether it was. Returns this rank's readings (None off `on_ranks`)."""
    from types import SimpleNamespace

    import torch.distributed as dist
    from vegs_torch.parallel.tile_sharded import tile_render_local
    from vegs_torch.parallel.tp_trainer import _image_loss, _whole_image

    rec = {}
    h, w = cam.height, cam.width
    bg = torch.zeros(3, device=gt.device)
    out_loc, _, _ = tile_render_local(plan, cam, cfg, 3, comm, *arrays,
                                      record=rec)
    rgb, out = _whole_image(out_loc, comm, h, w, bg)
    loss, _, nloss = _image_loss(rgb, out, gt, nm, opt_cfg, True, h, w)
    loss = (loss + opt_cfg.lambda_dnormal * nloss) / comm.size
    dout, d_pf, d_pa = torch.autograd.grad(
        loss, [rec["blend_out"], *rec["gather_out"]])
    res = None
    if comm.index in on_ranks:
        pf, pa, ts, grid, hp, wp = rec["blend_args"]
        ns = SimpleNamespace(payload_f32=pf, payload_aux=pa, grid=grid,
                             pay_rows=rec["pay_rows"],
                             binned=SimpleNamespace(tile_starts=ts,
                                                    gidx=rec["gidx"]))
        k1 = compare_k1(ns)
        k2 = compare_k2((pf, pa, ts, rec["blend_out"].detach(),
                         dout.contiguous(), grid))
        control = k2["deep_instances"] > 0
        for rows, scale in K2_SCALE.items():
            hold(f"K2 {rows} by {scale} (tile-sharded, rank {comm.index})",
                 k2[rows]["reading"][scale], K2_RTOL,
                 k2[rows]["control_reading"][scale] if control else None)
        if k2["flip_tiles"] > K2_MAX_FLIP_TILES * grid.num_tiles:
            raise AssertionError(f"K2: {k2['flip_tiles']} stop-flip tiles")
        k3 = compare_k3_fused((d_pf.contiguous(), d_pa.contiguous(),
                               rec["order_raw"], rec["ends"]), ns)
        for rows in ("f32_rows", "aux_rows"):
            hold(f"K3 fused {rows} (order_raw, rank {comm.index})",
                 k3[rows]["reading"], K3_RTOL, k3[rows]["control_reading"])
        k2.pop("pairs")
        res = {"rank": comm.index, "k1": k1, "k2": k2, "k3": k3,
               "k2_control_held": control,
               "local_tiles": int((ts[1:] > ts[:-1]).sum()),
               "instances": int(ts[-1])}
    dist.barrier()
    return res


def _parallel_rank(rank: int, tmp: str, device_type: str) -> dict:
    """One of the D = 2 gloo ranks of the parallel phase, both on card 0
    (or on the CPU, for a rehearsal)."""
    from vegs_torch import optim
    from vegs_torch.config import VegsConfig
    from vegs_torch.gaussians import DensifyStats
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.parallel import comm as C
    from vegs_torch.parallel.gauss_sharded import (make_gauss_mesh,
                                                   sharded_state_bytes)
    from vegs_torch.parallel.mesh import make_mesh
    from vegs_torch.parallel.tile_sharded import (make_tile_mesh,
                                                  make_tile_plan,
                                                  tile_render_local)
    from vegs_torch.parallel.tp_trainer import (make_tp_train_step,
                                                shard_train_state)
    from vegs_torch.perf.timing import card_line
    from vegs_torch.render import field_arrays
    from vegs_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type, 0 if device_type == "cuda" else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = Path(tmp)
    card = card_line()
    targets = torch.load(tmp / "targets.pt", weights_only=False)
    scene, _ = par_scene(tmp / "model", dev, targets)
    cams = scene.getTrainCameras()
    cfg = RasterizeConfig(k_cap=targets["k_cap"], k_pad=targets["k_pad"])
    tcfg = VegsConfig()
    comm = make_mesh(PAR_D).comm()
    transport = comm.transport(dev)
    gm, tm = make_gauss_mesh(PAR_D), make_tile_mesh(PAR_D)
    counters = main_counters()
    out = {"transport": transport, "card": card, "rank": rank}

    # TP: this rank's half of the field, Adam and statistics
    tcomm = tm.comm()
    state = shard_train_state(tm, clone_field(scene.gaussians),
                              optim.adam_init(scene.gaussians),
                              DensifyStats.zeros(scene.gaussians.capacity,
                                                 dev))
    out["rows"] = state[0].capacity
    out["state_bytes"] = sharded_state_bytes(scene.gaussians, PAR_D)
    cam0, gt0, nm0 = par_inputs(cams[0], dev)
    # size the ranks' raw capacity and the exchange's buckets by a probe of
    # the steps' cameras at twice the single-device capacity (a rank's
    # need is its half's, and the halves differ)
    probe_cfg = cfg._replace(k_cap=2 * cfg.k_cap)
    probes = []
    with torch.no_grad():
        for ci in PAR_CAMS:
            rec, camp = {}, cams[ci].device_params(dev)
            _, _, (dropped, needed, needed_exch) = tile_render_local(
                make_tile_plan(PAR_D, camp, probe_cfg), camp, probe_cfg, 3,
                tcomm, *field_arrays(state[0], 3), record=rec)
            probes.append({"cam": ci, "needed": int(needed),
                           "needed_exch": int(needed_exch),
                           "dropped": int(dropped), "bucket_sizes": [
                               int(x) for x in rec["bucket_sizes"]]})
    del rec
    cfg = cfg._replace(k_cap=r512(max(p["needed"] for p in probes) * 1.05))
    k_exch = r512(max(p["needed_exch"] for p in probes) * 1.05)
    plan = make_tile_plan(PAR_D, cam0, cfg, k_exch)
    out["exchange"] = {"probes": probes, "k_cap": cfg.k_cap,
                       "k_loc": plan.k_loc, "k_exch": k_exch,
                       "k_blend": plan.k_blend}

    # the sharded renders of camera 0 against the single-device render
    ref = {k: v.to(dev) for k, v in
           torch.load(tmp / "render.pt", weights_only=True).items()}
    r = par_renders(scene.gaussians, cam0,
                    cfg._replace(k_pad=targets["k_pad_nosat"]), gm, tm)
    out["renders_equal"] = {"gauss": equal_to(ref, r["gauss"]),
                            "tile": equal_to(ref, r["tile"]),
                            "tile_dropped": r["tile_dropped"]}
    del r, ref
    out["kernel_checks"] = par_kernel_checks(plan, cam0, gt0, nm0, cfg,
                                             tcfg.opt, tcomm,
                                             field_arrays(state[0], 3))
    torch.cuda.empty_cache()
    step = make_tp_train_step(tm, tcfg.opt, cfg, float(scene.cameras_extent),
                              cam0, use_normal_loss=True, k_exch=k_exch)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, ms, m = par_tp_steps(step, state, cams, dev)
    out["tp"] = {"ms": ms, "metrics": m, "launches": counts(counters),
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}
    d1 = torch.load(tmp / f"tp_d1_block{rank}.pt", weights_only=True)
    out["tp"]["mu_gap_d1"] = mu_gap(moments(state[1]),
                                    {k: v.to(dev) for k, v in d1.items()})
    del state, step, d1
    torch.cuda.empty_cache()

    # DP: the whole field on each rank, 2 cameras a step
    trainer = Trainer(tcfg, scene, raster_cfg=cfg, device=dev,
                      dp_devices=PAR_D, comm=comm)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ms, losses = par_trainer_steps(trainer, cams, explicit=False)
    st = trainer.state
    sums = C.all_gather(C.checksum(
        [getattr(st.field, k) for k in optim.PARAM_LEAVES]
        + [st.opt[x][k] for x in ("mu", "nu") for k in optim.PARAM_LEAVES]
        + [st.stats.xyz_gradient_accum, st.stats.denom,
           st.stats.max_radii2d])[None], comm)
    out["dp"] = {"ms": ms, "launches": counts(counters),
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "checksums": sums.cpu().tolist(), "loss": losses}
    return out


def parallel_phase(dev, card) -> dict:
    """Multi-device training at full width (see phase 14)."""
    import torch.distributed as dist
    from vegs_torch import optim
    from vegs_torch.config import VegsConfig
    from vegs_torch.gaussians import DensifyStats
    from vegs_torch.ops.rasterize import RasterizeConfig
    from vegs_torch.parallel import launch
    from vegs_torch.parallel.gauss_sharded import (make_gauss_mesh,
                                                   sharded_state_bytes)
    from vegs_torch.parallel.mesh import make_mesh
    from vegs_torch.parallel.tile_sharded import make_tile_mesh
    from vegs_torch.parallel.tp_trainer import (make_tp_train_step,
                                                shard_train_state)
    from vegs_torch.render import render
    from vegs_torch.train import Trainer

    counters = main_counters()
    res = {}
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        t0 = time.perf_counter()
        scene, targets = par_scene(tmp / "model", dev)
        cams = scene.getTrainCameras()
        cfg = RasterizeConfig(k_cap=targets["k_cap"], k_pad=targets["k_pad"])
        torch.save(targets, tmp / "targets.pt")
        tcfg = VegsConfig()
        extent = float(scene.cameras_extent)
        setup_s = time.perf_counter() - t0

        # -- D = 1 under NCCL, in this process -----------------------------
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv_d1",
                                world_size=1, rank=0)
        try:
            comm = make_mesh(1).comm()
            transport = comm.transport(dev)

            def trainer(**kw):
                sc = copy.copy(scene)
                sc.gaussians = clone_field(scene.gaussians)
                return Trainer(tcfg, sc, raster_cfg=cfg, device=dev, **kw)

            single, mid = trainer(), {}
            single_ms, single_loss = par_trainer_steps(single, cams, mid=mid)
            mu_single = moments(single.state.opt)
            params_single = [getattr(single.state.field, k)
                             for k in optim.PARAM_LEAVES]
            control = mu_gap(mid, mu_single)
            del single
            # the floor: the same single-device steps again
            again = trainer()
            par_trainer_steps(again, cams)
            floor = mu_gap(moments(again.state.opt), mu_single)
            del again

            for c in counters.values():
                c.launches = 0
            torch.cuda.reset_peak_memory_stats()
            dp = trainer(dp_devices=1, comm=comm)
            dp_ms, dp_loss = par_trainer_steps(dp, cams)
            dp_launches = counts(counters)
            dp_peak = torch.cuda.max_memory_allocated()
            dp_gap = mu_gap(moments(dp.state.opt), mu_single)
            dp_bits = all(torch.equal(getattr(dp.state.field, k), p)
                          for k, p in zip(optim.PARAM_LEAVES, params_single))
            del dp, params_single

            with torch.inference_mode():
                ro = render(cams[0], scene.gaussians,
                            config=cfg._replace(forward_only=True))
                ref = {"rgb": ro.rgb, "depth": ro.depth, "alpha": ro.alpha}
            torch.save({k: v.cpu() for k, v in ref.items()},
                       tmp / "render.pt")
            for c in counters.values():
                c.launches = 0
            r1 = par_renders(scene.gaussians, cams[0].device_params(dev),
                             cfg._replace(k_pad=targets["k_pad_nosat"]),
                             make_gauss_mesh(1), make_tile_mesh(1))
            render_launches = counts(counters)
            renders_equal = {"gauss": equal_to(ref, r1["gauss"]),
                             "tile": equal_to(ref, r1["tile"])}
            del r1, ref, ro

            tm = make_tile_mesh(1)
            state = shard_train_state(tm, clone_field(scene.gaussians),
                                      optim.adam_init(scene.gaussians),
                                      DensifyStats.zeros(
                                          scene.gaussians.capacity, dev))
            step = make_tp_train_step(tm, tcfg.opt, cfg, extent,
                                      cams[0].device_params(dev),
                                      use_normal_loss=True)
            for c in counters.values():
                c.launches = 0
            torch.cuda.reset_peak_memory_stats()
            state, tp_ms, tp_m = par_tp_steps(step, state, cams, dev)
            tp_launches = counts(counters)
            tp_peak = torch.cuda.max_memory_allocated()
            mu_tp = moments(state[1])
            tp_gap = mu_gap(mu_tp, mu_single)
            half = scene.gaussians.capacity // PAR_D
            for r in range(PAR_D):
                torch.save({k: v[r * half:(r + 1) * half].cpu()
                            for k, v in mu_tp.items()},
                           tmp / f"tp_d1_block{r}.pt")
            del state, step, mu_tp
        finally:
            dist.destroy_process_group()
        d1 = {"transport": transport, "setup_s": setup_s,
              "k_cap": cfg.k_cap, "k_pad": cfg.k_pad,
              "need_raw": targets["need_raw"],
              "single_ms": single_ms, "dp_ms": dp_ms, "tp_ms": tp_ms,
              "single_loss": single_loss, "dp_loss": dp_loss,
              "dp_mu_gap": dp_gap, "dp_bit_equal": dp_bits,
              "tp_mu_gap": tp_gap, "floor_mu_gap": floor,
              "control_mu_gap": control, "limit": PAR_MU_RTOL,
              "renders_equal": renders_equal, "tp_metrics": tp_m,
              "launches": {"dp": dp_launches, "renders": render_launches,
                           "tp": tp_launches},
              "max_memory_allocated": {"dp": dp_peak, "tp": tp_peak},
              "state_bytes": sharded_state_bytes(scene.gaussians, 1)}
        emit("parallel_d1", card=card, **d1)
        hold("DP D=1 moments against the single-device step", dp_gap,
             PAR_MU_RTOL, control)
        hold("TP D=1 moments against the single-device step", tp_gap,
             PAR_MU_RTOL, control)
        del mu_single, mid, scene, cams
        torch.cuda.empty_cache()

        # -- D = 2: two gloo-host ranks sharing the card --------------------
        t1 = time.perf_counter()
        ranks = launch.spawn(_parallel_rank, PAR_D, str(tmp), dev.type,
                             backend="gloo", init_file=tmp / "rdv_d2")
        d2_s = time.perf_counter() - t1
    for r in ranks:
        kc = r.pop("kernel_checks")
        if kc is not None:
            emit("parallel_kernels", card=card, transport=r["transport"],
                 scene="376x1408, 2,233,571 Gaussians, rank 0 of 2, first "
                       "tile-sharded step", **kc)
            if not kc["k2_control_held"]:
                raise AssertionError("K2's control held on no rank")
            res["kernel_checks"] = kc
        emit("parallel_d2", **r)
    for r in ranks:
        if not all(all(v.values()) for v in (r["renders_equal"]["gauss"],
                                             r["renders_equal"]["tile"])):
            raise AssertionError(f"rank {r['rank']}: sharded render differs "
                                 f"from the single-device one: {r}")
        if r["tp"]["metrics"]["num_dropped"] or r["renders_equal"][
                "tile_dropped"]:
            raise AssertionError(f"rank {r['rank']} dropped instances")
        hold(f"TP D=2 rank {r['rank']} moments against TP D=1",
             r["tp"]["mu_gap_d1"], PAR_MU_RTOL, control)
        sums = r["dp"]["checksums"]
        if any(s != sums[0] for s in sums):
            raise AssertionError(f"replicated state differs across ranks: "
                                 f"{sums}")
    if not all(all(v.values()) for v in renders_equal.values()):
        raise AssertionError(f"D=1 sharded renders differ: {renders_equal}")
    launches = {k: dp_launches[k] + render_launches[k] + tp_launches[k]
                + sum(r["tp"]["launches"][k] + r["dp"]["launches"][k]
                      for r in ranks) for k in counters}
    for k, n in launches.items():
        if not n:
            raise AssertionError(f"{k} never launched on the parallel paths")
    if min(dp_launches["K4"], *(r["dp"]["launches"]["K4"] for r in ranks)) < 1:
        raise AssertionError("K4 not launched in a DP step")
    res.update(d1=d1, ranks=ranks, launches=launches, d2_s=d2_s)
    emit("parallel", card=card, d2_s=d2_s, launches=launches,
         transports={"d1": transport, "d2": ranks[0]["transport"]})
    return res


QUALITY_CONTROL_ITERS = 900  # the controls are read at JAX's it900


def round5_ssim(img1, img2, window_size=11, sigma=1.5):
    """SSIM as the JAX package computed it before its round-5 fix: the
    package's depthwise filter (bf16 inside `ssim_control`) and the
    variances E[x^2] - mu^2 left unclamped."""
    from vegs_torch.losses import photometric as P

    window = torch.from_numpy(P._gaussian_window(window_size, sigma)).to(
        img1.device)

    def filt(x):
        return P._DepthwiseFilter.apply(x, window)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1, s2 = filt(img1 * img1) - mu1_sq, filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu12 + c1) * (2 * s12 + c2))
                      / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))


class ssim_control:
    """The quality phase's controls, patched in while the context is open:
    SSIM's depthwise filter with its input and window cast to bf16
    (`vegs_torch.losses.photometric._filter_f32`), and, with clamp=False,
    the Trainer's SSIM (`vegs_torch.train.ssim`: the step's loss and the
    evaluation) without the variance clamp (`round5_ssim`) -- the JAX
    package's SSIM before its round-5 fix (a bf16 convolution inside the
    variance cancellation, which cost its static arm 22 dB at 128x256;
    the fix made the convolution float32 and clamped the variances)."""

    def __init__(self, clamp: bool):
        self.clamp = clamp

    def __enter__(self):
        import torch.nn.functional as F

        from vegs_torch import train
        from vegs_torch.losses import photometric

        def filter_bf16(img, window):
            c = img.shape[0]
            rhs = window.to(torch.bfloat16)[None, None].expand(
                c, 1, *window.shape)
            return F.conv2d(img.to(torch.bfloat16)[None], rhs,
                            padding=window.shape[-1] // 2,
                            groups=c)[0].float()

        self.saved = (photometric._filter_f32, train.ssim)
        photometric._filter_f32 = filter_bf16
        if not self.clamp:
            train.ssim = round5_ssim
        return self

    def __exit__(self, *exc):
        from vegs_torch import train
        from vegs_torch.losses import photometric

        photometric._filter_f32, train.ssim = self.saved


def quality_phase(dev, card) -> dict:
    """Arm A of the end-to-end quality runs in full, its kernels on the
    last step's inputs, and the control (see phase 15)."""
    from vegs_torch.perf import quality as q

    t0 = time.perf_counter()
    band = q.PSNR_BAND_DB
    info, _, _ = q.build_scene_info(np.random.default_rng(q.SCENE_SEED),
                                    h=q.H, w=q.W, n_cams=q.N_CAMS)
    counters = all_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    run = q.train_arm("A", info, iters=q.ITERS, device=dev,
                      log=lambda m: None)
    launches = {k: c.launches for k, c in counters.items()}
    arm_a = run.record()
    last = arm_a["trend"][-1]
    emit("quality", run="arm A", card=card, trend=arm_a["trend"],
         ms_per_step_median=arm_a["ms_per_step_median"],
         wall_s=arm_a["wall_s"], kcap_path=arm_a["kcap_path"],
         launches=launches, jax=q.JAX_FULL["A"], psnr_band=band,
         ssim_band=q.SSIM_BAND)
    short = [k for k in ("K1", "K2", "K3") if launches[k] < q.ITERS]
    if short or not launches["K4"] or launches["M1"] or launches["M2"]:
        raise AssertionError(f"quality run launches {launches}")
    hold("arm A final PSNR against JAX's", abs(last["psnr"]
                                              - q.JAX_FULL["A"][0]), band)
    hold("arm A final SSIM against JAX's", abs(last["ssim"]
                                              - q.JAX_FULL["A"][1]),
         q.SSIM_BAND)

    # K1-K3 (and K4 if its gate is on) against their plain versions on the
    # last step's inputs: the densified field at the adapted capacity
    tr, cam = run.tr, run.last_cam
    k2_args, k3_args, st, _ = step_kernel_inputs(tr, cam, q.ITERS, dev,
                                                 need_sat=False)
    late = {"k_cap": tr.raster_cfg.k_cap, "k_pad": tr.raster_cfg.k_pad,
            "active": int(tr.state.field.num_active()),
            "sat_cull": st.sat_counts is not None,
            "k2": compare_k2(k2_args), "k3": compare_k3_fused(k3_args, st)}
    with torch.no_grad():
        late["k1"] = compare_k1(st)
        if st.sat_counts is not None:
            late["k4"] = compare_k4(st)
    k2, k3f = late["k2"], late["k3"]
    k2.pop("pairs")
    emit("quality_kernels", scene="128x256, arm A after 1,500 iterations",
         card=card, k2_limit=K2_RTOL, k3_limit=K3_RTOL, **late)
    for rows, scale in K2_SCALE.items():
        hold(f"quality K2 {rows} by {scale}", k2[rows]["reading"][scale],
             K2_RTOL, k2[rows]["control_reading"][scale])
    if k2["flip_tiles"] > K2_MAX_FLIP_TILES * st.grid.num_tiles:
        raise AssertionError(f"quality K2: {k2['flip_tiles']} stop-flip tiles")
    for rows in ("f32_rows", "aux_rows"):
        hold(f"quality K3 {rows}", k3f[rows]["reading"], K3_RTOL,
             k3f[rows]["control_reading"])
    del run, tr, k2_args, k3_args, st

    # the controls, the same run read at it900: the bf16 filter alone (the
    # variance clamp kept; reported), then the JAX round-5 SSIM (must miss)
    controls = {}
    for key, clamp, what in (
            ("control_bf16", True, "SSIM filter in bf16, variances clamped"),
            ("control", False, "the JAX round-5 SSIM: filter in bf16, "
                               "variances unclamped")):
        with ssim_control(clamp):
            ctl = q.Run(key, q.arm_trainer("A", info, iters=q.ITERS,
                                           device=dev), log=lambda m: None)
            ctl.train(1, QUALITY_CONTROL_ITERS, q.EVAL_EVERY)
        controls[key] = ctl.record()
        del ctl
        c = controls[key]["trend"][-1]
        off = abs(c["psnr"] - q.JAX_A_IT900)
        emit("quality_control", run=f"arm A, {what}", card=card,
             must_miss=not clamp, trend=controls[key]["trend"],
             jax_it900=q.JAX_A_IT900, psnr_band=band, off_by=off,
             ms_per_step_median=controls[key]["ms_per_step_median"])
        if not clamp and not off > band:
            raise AssertionError(f"the control reads {c['psnr']} dB at it"
                                 f"{c['it']}, within {band} dB of JAX's "
                                 f"{q.JAX_A_IT900}: the band is too loose")
    torch.cuda.empty_cache()
    res = {"arm_a": arm_a, **controls, "launches": launches, "late": late,
           "phase_s": time.perf_counter() - t0,
           "setting": {"device": torch.cuda.get_device_name(0), "card": card}}
    emit("quality_phase", seconds=res["phase_s"], card=card)
    return res


TPQ_D = 4                  # ranks of the TP quality runs, on the one card
TPQ_DEMO_ITERS = 110       # r05b's demo, shortened: the stale cap at it 60
TPQ_SWAP = (60, 32768)
TPQ_MASK_ITERS = 160       # r05's seed-0 TP run to its first densify event


def tpq_after(mesh, scene, spec, last):
    """In each rank after a TP quality run (`quality_tp.run_tp`'s `after`):
    on the run that asks, K1-K3 against their plain versions on the inputs
    the next step would take -- the static and box rows of this rank, the
    box moved by its residual -- on ranks 0 and 1 (the ranks that own tile
    rows at 32x64; ranks 2 and 3 own the grid's padding)."""
    if not spec.get("checks"):
        return None
    from vegs_torch.boxmodel import adjust_box2world
    from vegs_torch.parallel.tile_sharded import make_tile_plan
    from vegs_torch.perf.quality_tp import opt_config
    from vegs_torch.render import (_concat_arrays, field_arrays,
                                   transform_field_arrays)

    comm = mesh.comm()
    b2w = adjust_box2world(last["b2w"], last["deltas"])[0].detach()
    arrays = _concat_arrays([
        field_arrays(last["field"], 3),
        transform_field_arrays(field_arrays(last["bfield"], 3), b2w)])
    cam, cfg = last["cam"], last["raster"]
    return par_kernel_checks(make_tile_plan(comm.size, cam, cfg), cam,
                             last["gt"], last["normal"], cfg, opt_config(),
                             comm, arrays, on_ranks=(0, 1))


def tp_quality_phase(dev, card) -> dict:
    """The fully sharded trainer's quality runs, shortened (see phase
    16)."""
    from vegs_torch.config import OptimizationParams
    from vegs_torch.perf import quality_tp as qt

    t0 = time.perf_counter()
    demo_spec = {"kind": "full", "seed": 0, "iters": TPQ_DEMO_ITERS,
                 "every": None, "densify": None, "k_cap": qt.K_CAP,
                 "adapter": qt.R05B_ADAPTER, "swap": TPQ_SWAP,
                 "grad_threshold": OptimizationParams().densify_grad_threshold}
    mask_spec = {"kind": "full", "seed": 0, "iters": TPQ_MASK_ITERS,
                 "every": None, "densify": qt.R05_DENSIFY, "k_cap": qt.K_CAP,
                 "adapter": qt.R05_ADAPTER, "masks": True, "checks": True}
    demo, r05 = qt.run_tp([demo_spec, mask_spec], ndev=TPQ_D, device=dev,
                          after=tpq_after)
    run_s = time.perf_counter() - t0
    launches = {k: sum(r["step_launches"][k] for rec in (demo, r05)
                       for r in rec["ranks"])
                for k in ("K1", "K2", "K3", "K4", "M1", "M2")}
    ordered, clean = qt.adapter_order_ok(demo["adapter_events"],
                                         demo["dropped"])
    emit("tp_quality_adapter", card=card, ranks=TPQ_D, transport="gloo-host",
         run=f"r05b shortened: k_cap 1024, floor 512, window 25, the stale "
             f"{TPQ_SWAP[1]} at it {TPQ_SWAP[0]}, {TPQ_DEMO_ITERS} iterations",
         events=demo["adapter_events"], jax_r05b=qt.JAX_R05B,
         rebuilds_by_rank=[r["rebuilds"] for r in demo["ranks"]],
         dropped_steps=[i + 1 for i, x in enumerate(demo["dropped"]) if x],
         ordered=ordered, no_drop_after_last_grow=clean,
         final_psnr=demo["final_psnr"],
         ms_per_step_median=[r["ms_per_step_median"] for r in demo["ranks"]],
         step_launches=[r["step_launches"] for r in demo["ranks"]],
         wall_s=demo["wall_s"])
    emit("tp_quality_masks", card=card, ranks=TPQ_D,
         run=f"r05 seed 0 to its first densify event (it {TPQ_MASK_ITERS})",
         masks=r05["masks"], jax_masks=qt.JAX_R05_MASKS,
         events=r05["adapter_events"], jax_events=qt.JAX_R05_ADAPTER,
         rebuilds_by_rank=[r["rebuilds"] for r in r05["ranks"]],
         densify=r05["densify"], final_psnr=r05["final_psnr"],
         box_err=r05["box_err"], box_err_raw=r05["box_err_raw"],
         ms_per_step_median=[r["ms_per_step_median"] for r in r05["ranks"]],
         step_launches=[r["step_launches"] for r in r05["ranks"]],
         wall_s=r05["wall_s"])
    checks = [r["after"] for r in r05["ranks"] if r.get("after")]
    for c in checks:
        emit("tp_quality_kernels", card=card,
             scene=f"32x64, r05 seed 0 after {TPQ_MASK_ITERS} iterations, "
                   f"rank {c['rank']} of {TPQ_D}", k2_limit=K2_RTOL,
             k3_limit=K3_RTOL, **c)
    if not (ordered and clean):
        raise AssertionError(f"adapter demo: events {demo['adapter_events']}"
                             f", dropped at {demo['dropped']}")
    for rec, what in ((demo, "demo"), (r05, "r05")):
        if not qt.ranks_agree(rec):
            raise AssertionError(f"{what}: ranks rebuilt at different "
                                 f"iterations: {rec['ranks']}")
        if not qt.step_launches_ok(rec):
            raise AssertionError(f"{what}: TP step launches "
                                 f"{[r['step_launches'] for r in rec['ranks']]}")
    ev = r05["adapter_events"]
    if not ev or any(k != "decay" for _, k, _ in ev):
        raise AssertionError(f"r05 seed 0: adapter events {ev}")
    if [m["it"] for m in r05["masks"]] != [TPQ_MASK_ITERS] or any(
            sum(m["diffs"]) for m in r05["masks"]):
        raise AssertionError(f"mask report {r05['masks']}")
    if len(checks) != 2 or not any(c["k2_control_held"] for c in checks):
        raise AssertionError(f"K2's control held on no rank: {checks}")
    res = {"demo": demo, "r05": r05, "kernel_checks": checks,
           "launches": launches, "run_s": run_s,
           "phase_s": time.perf_counter() - t0}
    emit("tp_quality", card=card, launches=launches, run_s=run_s,
         seconds=res["phase_s"])
    return res


TILE_SHAPES = ((16, 32), (32, 16), (32, 32))  # K2's 16- and 32-warp builds
TILES_N = 500_000    # bench.py's `value` scale (vegs_torch.perf.tiles)
TILES_DEEP, TILES_OTHERS = 32, 32  # K2's plain walk: deepest and seeded tiles


def tile_subset(tile_starts, grid, seed=SEED) -> list:
    """The tiles K2 is held on at a wide shape: the TILES_DEEP deepest and
    TILES_OTHERS others with instances drawn from `seed` (the plain K2
    walks every tile in Python, ~13 s a frame at full width)."""
    counts = (tile_starts[1:] - tile_starts[:-1]).cpu().numpy()
    deep = np.argsort(-counts, kind="stable")[:TILES_DEEP]
    rest = np.setdiff1d(np.flatnonzero(counts > 0), deep)
    others = np.random.default_rng(seed).choice(
        rest, size=min(TILES_OTHERS, len(rest)), replace=False)
    return sorted(int(t) for t in np.concatenate([deep, others]))


def tile_kernel_checks(st, out_p, dout, tiles_held) -> dict:
    """K1, K2, K3 and K4 (where its gate is on) of one wide-tile fwd+bwd
    against their plain versions, with phase 4's and phase 8's limits and
    controls: K1 on every tile (its `pairs` give K2's bound); K2 on the
    tiles `tiles_held` (`tile_subset`), f32 and aux rows, the control the
    output 1% off after each tile's first 256 instances; two K2 runs equal
    to the bit; K3 (the gather's whole backward) on K2's output; K4's
    counts. Returns the readings, K2's ms and bound."""
    from vegs_torch.ops import blend_cuda, segreduce
    from vegs_torch.perf import roofline
    from vegs_torch.perf.timing import cuda_ms

    g = st.grid
    hp, wp = g.padded_height, g.padded_width
    pf, pa = st.payload_f32.detach(), st.payload_aux.detach()
    ts = st.binned.tile_starts
    k = pf.shape[1]
    k2_args = (pf, pa, ts, out_p.detach(), dout.contiguous(), g)
    # K1 on every tile
    out, stop = blend_cuda.blend(pf, pa, ts, g, hp, wp, return_stop=True)
    pairs = {}
    ref, stop_ref = blend_cuda.blend_ref_tiles(pf, pa, ts, g, hp, wp,
                                               return_stop=True, pairs=pairs)
    flips_px = stop != stop_ref
    d = (out - ref).abs()
    bad = int(((d > K1_ATOL + K1_RTOL * ref.abs()).any(dim=0)
               & ~flips_px).sum())
    k1 = {"stop_flips": int(flips_px.sum()), "pixels": hp * wp,
          "max_abs_err": float(d.masked_fill(flips_px[None], 0).max()),
          "bad_pixels": bad}
    if bad or k1["stop_flips"] > MAX_FLIP_SHARE * hp * wp:
        raise AssertionError(f"K1 at {g.tile_h}x{g.tile_w}: {k1}")
    # K2 on the held tiles
    kpf, kpa = blend_cuda.blend_bwd(*k2_args)
    again = blend_cuda.blend_bwd(*k2_args)
    t0 = time.perf_counter()
    rpf, rpa = blend_cuda.blend_bwd_ref_tiles(*k2_args, tiles=tiles_held)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for x in (kpf, kpa, rpf, rpa):
        if not torch.isfinite(x).all():
            raise AssertionError("K2 or its plain version is not finite")
    flips = flips_px.reshape(g.nty, g.tile_h, g.ntx, g.tile_w).any(
        dim=3).any(dim=1).reshape(-1)
    held = torch.zeros(g.num_tiles, dtype=torch.bool, device=ts.device)
    held[tiles_held] = True
    tile, batch = slot_tiles(ts, k, g)
    keep = held[tile] & ~flips[tile] & (torch.arange(k, device=ts.device)
                                        < ts[-1])
    ctl = deep_control(ts, k, g)
    bf16_ulp = BF16_ULP if pa.dtype == torch.bfloat16 else 0.0
    k2 = {"tiles_held": len(tiles_held),
          "flip_tiles_held": int(flips[tiles_held].sum()),
          "instances_held": int(keep.sum()),
          "deep_instances_held": int((keep & (batch > 0)).sum()),
          "bit_identical_rerun": bool(
              torch.equal(bits(kpf), bits(again[0]))
              and torch.equal(bits(kpa), bits(again[1]))),
          "plain_ms_held_tiles": plain_s * 1e3}
    for rows, kk, r, ulp in (("f32_rows", kpf, rpf, 0.0),
                             ("aux_rows", kpa, rpa.float(), bf16_ulp)):
        k_ctl = (kk.float() * ctl).to(kk.dtype).float()
        k2[rows] = {
            "reading": k2_readings(kk.float(), r, ts, g, keep, ulp),
            "control_reading": k2_readings(k_ctl, r, ts, g, keep, ulp)}
    k2["max_abs_err"] = float(max(
        (kpf - rpf)[:, keep].abs().max(),
        (kpa.float() - rpa.float())[:, keep].abs().max()))
    shape = f"{g.tile_h}x{g.tile_w}"
    for rows, scale in K2_SCALE.items():
        hold(f"K2 {rows} by {scale} at {shape}", k2[rows]["reading"][scale],
             K2_RTOL, k2[rows]["control_reading"][scale])
    if k2["flip_tiles_held"] > K2_MAX_FLIP_TILES * len(tiles_held) + 1:
        raise AssertionError(f"K2 at {shape}: {k2['flip_tiles_held']} "
                             "stop-flip tiles among the held")
    if not k2["bit_identical_rerun"]:
        raise AssertionError(f"K2 at {shape}: two runs differ")
    k2["ms"] = cuda_ms(lambda: blend_cuda.blend_bwd(*k2_args))
    k2_bytes, k2_ops = roofline.k2_work(pairs, pa.element_size(), k,
                                        g.num_tiles, hp, wp)
    k2["bound_ms"], k2["bound_by"] = roofline.bound_ms(
        roofline.Work(k2_bytes, k2_ops))
    k2["pairs"] = pairs
    # K3 on K2's output, as the main path runs it
    ends = torch.cat([st.binned.gauss_ends, st.binned.gauss_ends[-1:]])
    k3 = compare_k3_fused((kpf, kpa, st.binned.order, ends), st)
    for rows in ("f32_rows", "aux_rows"):
        hold(f"K3 {rows} at {shape}", k3[rows]["reading"], K3_RTOL,
             k3[rows]["control_reading"])
    k3 = {r: k3[r] for r in ("segments", "rows", "f32_rows", "aux_rows",
                             "max_abs_err", "plain_ms")}
    # K4 where its gate is on
    k4 = compare_k4(st) if st.sat_counts is not None else None
    return {"k1": k1, "k2": k2, "k3": k3, "k4": k4}


def tiles_phase(dev, card, scene) -> dict:
    """Phase 9b: wide tiles through the main path at 376x1408 (see the
    module docstring). `scene` is the train phase's: one static Trainer
    step at each wide shape on its field. Returns per shape the Trainer
    step's and the fwd+bwd's launches and the kernel readings, and the
    sweep's lines."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.ops.blend_cuda import BlendFn
    from vegs_torch.ops.binning import TileGrid
    from vegs_torch.ops.rasterize import (SAT_MIN_SLOTS_PER_TILE,
                                          RasterizeConfig, raster_out, stage)
    from vegs_torch.perf import tiles as tiles_mod
    from vegs_torch.perf.refscale import build_scene
    from vegs_torch.train import Trainer

    def grid_of(th, tw):
        return TileGrid.for_image(H, W, th, tw)

    t0 = time.perf_counter()
    counters = all_counters()
    cams = scene.getTrainCameras()
    res = {"steps": {}, "shapes": {}}
    # one static Trainer step a shape on the train phase's field
    for i, (th, tw) in enumerate(TILE_SHAPES):
        with torch.inference_mode():
            cfg, need_raw, need_pad = sized_config(scene.gaussians, cams, dev,
                                                   tile=(th, tw))
        trainer = Trainer(VegsConfig(), scene, raster_cfg=cfg, device=dev)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t1 = time.perf_counter()
        m = trainer.train_iteration(TRAIN_FIRST_IT + i, camera=cams[i])
        torch.cuda.synchronize()
        step = {"ms": (time.perf_counter() - t1) * 1e3,
                "launches": {k: c.launches for k, c in counters.items()},
                "k_cap": cfg.k_cap, "k_pad": cfg.k_pad, "need_raw": need_raw,
                "need_pad": need_pad,
                "sat_gate_on": cfg.k_cap >= (SAT_MIN_SLOTS_PER_TILE
                                             * grid_of(th, tw).num_tiles),
                **{k: float(m[k]) for k in ("loss", "num_dropped")}}
        del trainer
        want = {"K1": 1, "K2": 1, "K3": 1, "K4": int(step["sat_gate_on"]),
                "M1": 0, "M2": 0}
        if (not np.isfinite(step["loss"]) or step["num_dropped"]
                or step["launches"] != want):
            raise AssertionError(f"the Trainer step at {th}x{tw}: {step}")
        res["steps"][f"{th}x{tw}"] = step
        emit("tiles_step", tile=f"{th}x{tw}", n=N_REF, card=card, **step)
    torch.cuda.empty_cache()

    # rasterize fwd+bwd on bench.py's 500k scene, the kernels held; the
    # scene and each shape's k_cap serve the sweep too
    cam, arrays = build_scene(TILES_N, H, W, dev)
    sized_all = tiles_mod.size_shapes(cam, arrays)
    bg = torch.zeros(3, device=dev)
    for th, tw in TILE_SHAPES:
        shape = f"{th}x{tw}"
        sized = sized_all[th, tw]
        cfg = RasterizeConfig(k_cap=sized["k_cap"], tile_h=th, tile_w=tw)
        leaves = [x.clone().requires_grad_(True) for x in arrays]
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        st = stage(*leaves, cam, config=cfg)
        g = st.grid
        out_p = BlendFn.apply(st.payload_f32, st.payload_aux,
                              st.binned.tile_starts, g, g.padded_height,
                              g.padded_width)
        ro = raster_out(st, out_p[:, :H, :W], bg)
        loss = ro.rgb.square().mean() + 0.01 * ro.depth.square().mean()
        (dout,) = torch.autograd.grad(loss, out_p, retain_graph=True)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        gate = st.sat_counts is not None
        want = {"K1": 1, "K2": 1, "K3": 1, "K4": int(gate), "M1": 0, "M2": 0}
        if launches != want:
            raise AssertionError(f"fwd+bwd at {shape}: launches {launches}, "
                                 f"expected {want}")
        if not all(torch.isfinite(x).all() for x in grads):
            raise AssertionError(f"fwd+bwd at {shape}: gradients not finite")
        if int(st.binned.num_dropped):
            raise AssertionError(f"fwd+bwd at {shape} drops instances")
        checks = tile_kernel_checks(st, out_p, dout,
                                    tile_subset(st.binned.tile_starts, g))
        res["shapes"][shape] = {"k_cap": sized["k_cap"], "need": sized["need"],
                                "tiles": g.num_tiles, "sat_gate_on": gate,
                                "loss": float(loss.detach()),
                                "launches": launches,
                                **checks}
        emit("tiles_check", tile=shape, n=TILES_N, card=card,
             limit=K2_RTOL, held=K2_SCALE, **res["shapes"][shape])
        del st, out_p, dout, grads, leaves, ro, loss
        torch.cuda.empty_cache()

    # the sweep (r05_tiles.py), every kernel's launches counted in it
    res["sweep"] = tiles_mod.sweep(
        device=dev, emit=lambda **kw: emit("tiles_sweep", **kw),
        scene=(cam, arrays), sized=sized_all)
    del cam, arrays
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    res["launches"] = {k: sum(x["launches"][k] for x in res["shapes"].values())
                       + sum(x["launches"][k] for x in res["steps"].values())
                       for k in counters}
    emit("tiles", seconds=res["seconds"], launches=res["launches"], card=card)
    return res


# timed calls of each probe line, and its profiled windows' calls: the
# probes' own CLIs time 20 (PERF.md keeps theirs); here they are driven
PROBE_ITERS, PROBE_WARMUP = 2, 1
DEBUG_ITERS = 50                    # r12's probe, cut from 200 and 300


def probes_phase(dev, card) -> dict:
    """Phase 17b: the main path's probes at bench shape (see the module
    docstring), every launch counter set to 0 just before. Returns their
    results and the launches."""
    from vegs_torch.perf import (binning_probes, quality_debug,
                                 satcull_analysis, stages)

    t0 = time.perf_counter()
    counters = all_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    kw = {"device": dev, "iters": PROBE_ITERS, "warmup": PROBE_WARMUP}
    parts, t1 = {}, time.perf_counter()

    def lap(name):
        nonlocal t1
        parts[name] = time.perf_counter() - t1
        t1 = time.perf_counter()

    res = {"stages": stages.run(**kw, emit=lambda **x: emit("stages", **x))}
    lap("stages")
    res["bisect"] = stages.bisect(**kw, emit=lambda **x: emit("stages", **x))
    lap("bisect")
    for name, fn in binning_probes.PROBES.items():
        res[name] = fn(**kw, emit=lambda **x: emit("binning_probes", **x))
        lap(name)
    exact = res["r06"]["delta_exact"]
    if not (exact["rec_cols"] and exact["gidx_col"]):
        raise AssertionError(f"r06's delta map is not exact: {exact}")
    if not res["r11"]["scan_exact"]:
        raise AssertionError("r11's scatter and cumsum differ from the gather")
    res["satcull"] = satcull_analysis.run(
        device=dev, emit=lambda **x: emit("satcull_analysis", **x))
    lap("satcull")
    res["debug"] = [quality_debug.probe(h, w, iters=DEBUG_ITERS, device=dev,
                                        log=lambda ln: emit(
                                            "quality_debug", **json.loads(ln)))
                    for h, w, _ in quality_debug.PROBES]
    res["grads"] = [quality_debug.grads(h, w, device=dev,
                                        log=lambda ln: emit(
                                            "quality_debug", **json.loads(ln)))
                    for h, w in quality_debug.SIZES]
    lap("quality_debug")
    for g in res["grads"]:
        for name, x in g["grads"].items():
            if not (np.isfinite(x["rms"]) and x["nonzero"] > 0):
                raise AssertionError(f"r12b {g['size']} {name}: {x}")
    res["launches"] = {k: c.launches for k, c in counters.items()}
    res["seconds"] = time.perf_counter() - t0
    emit("probes", launches=res["launches"], seconds=res["seconds"],
         parts=parts, card=card)
    missing = [k for k in ("K1", "K2", "K3") if not res["launches"][k]]
    if missing:
        raise AssertionError(f"the probes never launched {missing}")
    if res["launches"]["M1"] or res["launches"]["M2"]:
        raise AssertionError(f"the probes launched M1 or M2: "
                             f"{res['launches']}")
    return res


def k3_contract_bench(dev, card) -> dict:
    """K3 under the JAX contract at perf/r05_segreduce2.py's full shape
    (`vegs_torch.perf.gebwd`: [24, 1,126,912] columns, 500,224 segments,
    the last 223 empty) against `segment_reduce_ref` (compare_k3's limit
    and control), the empty segments 0; card, plain and library
    (`torch.segment_reduce` with the lengths) times, the bound from
    `roofline.k3_work`."""
    from vegs_torch.ops import segreduce
    from vegs_torch.perf import gebwd, roofline

    d = gebwd.r05s2_data(dev)
    cols, starts, ends = d["cols"], d["starts"], d["ends"]
    k3 = compare_k3(cols, starts, ends)
    got = segreduce.segment_reduce_cols(cols, starts, ends)
    empty = ends == starts
    times = kernel_times(
        lambda: segreduce.segment_reduce_cols(cols, starts, ends),
        lambda: segreduce.segment_reduce_ref(cols, starts, ends),
        k3_contract_library(cols, starts, ends))
    b, by = roofline.bound_ms(roofline.Work(*roofline.k3_work(
        cols.shape[0], int(ends[-1]), starts.shape[0])))
    res = {**k3, **times, "bound_ms": b, "bound_by": by, "limit": K3_RTOL,
           "empty_segments": int(empty.sum()),
           "empty_zero": not bool(got[:, empty].any()),
           "spans": segreduce.span_stats(ends)}
    emit("k3_contract_bench", scene="r05_segreduce2's shape", card=card,
         **res)
    hold("K3 JAX contract at r05_segreduce2's shape", k3["reading"], K3_RTOL,
         k3["control_reading"])
    if (not res["empty_zero"]
            or res["empty_segments"] < gebwd.ng_of(d.n) - d.n):
        raise AssertionError(f"K3's empty segments: {res}")
    return res


def k3_fused_r05(dev, card) -> dict:
    """K3 as the main path runs it (`gather_expand_bwd`) on
    perf/r05_segreduce.py's cotangents, permuted `order` and padded `ends`
    against its plain version, with phase 8's limits and controls."""
    from vegs_torch.perf import gebwd

    d = gebwd.r05s_data(dev)
    args = (d["d_pf_t"], d["d_pa_t"], d["order"], d["ends"])
    res = compare_k3_fused(args, None)
    emit("k3_fused_r05", scene="r05_segreduce's shape", card=card,
         limit=K3_RTOL, **res)
    for rows in ("f32_rows", "aux_rows"):
        hold(f"K3 fused on r05's spans, {rows}", res[rows]["reading"],
             K3_RTOL, res[rows]["control_reading"])
    return res


def micro_phase(dev, card) -> dict:
    """Phase 17c: the glue micro-probes, the gather backward's probes, the
    backward bisect and the sharded-path check (see the module docstring),
    every launch counter set to 0 just before; then K3 under the JAX
    contract and as the main path runs it at the probes' bench shapes
    against their plain versions."""
    from vegs_torch.ops import segreduce
    from vegs_torch.perf import gebwd, micro, shard_check, stages

    t0 = time.perf_counter()
    counters = all_counters()
    torch.cuda.synchronize()
    for c in (*counters.values(), segreduce.segment_reduce_cols):
        c.launches = 0
    kw = {"device": dev, "iters": PROBE_ITERS, "warmup": PROBE_WARMUP}
    parts, t1 = {}, time.perf_counter()

    def lap(name):
        nonlocal t1
        parts[name] = time.perf_counter() - t1
        t1 = time.perf_counter()

    res = {"micro": micro.run(**kw, emit=lambda **x: emit("micro", **x))}
    lap("micro")
    res["gebwd"] = gebwd.run(**kw, emit=lambda **x: emit("gebwd", **x))
    lap("gebwd")
    res["bwd_bisect"] = stages.bwd_bisect(
        **kw, emit=lambda **x: emit("bwd_bisect", **x))
    lap("bwd_bisect")
    res["shard"] = shard_check.run(
        **kw, emit=lambda **x: emit("shard_check", **x))
    lap("shard_check")
    res["launches"] = {k: c.launches for k, c in counters.items()}
    res["launches"]["K3 JAX contract"] = segreduce.segment_reduce_cols.launches
    bad = {k: ln["loss"] for k, ln in res["bwd_bisect"]["lines"].items()
           if not ln["finite"]}
    if bad:
        raise AssertionError(f"bwd_bisect: not finite: {bad}")
    res["k3_contract"] = k3_contract_bench(dev, card)
    res["k3_fused"] = k3_fused_r05(dev, card)
    lap("k3_checks")
    res["seconds"] = time.perf_counter() - t0
    emit("micro_phase", launches=res["launches"], seconds=res["seconds"],
         parts=parts, renders=res["shard"]["renders"], card=card)
    missing = [k for k in ("K1", "K2", "K3", "K3 JAX contract")
               if not res["launches"][k]]
    if missing:
        raise AssertionError(f"the micro phase never launched {missing}")
    if res["launches"]["M1"] or res["launches"]["M2"]:
        raise AssertionError(f"the micro phase launched M1 or M2: "
                             f"{res['launches']}")
    return res


def legacy_quality_phase(dev, card) -> dict:
    """Phase 17d: r03's run in full (`quality.run_r03`), every launch
    counter set to 0 just before: its final held-out PSNR at or above
    JAX's 11.92 dB less `quality.PSNR_BAND_DB` and within that band of the
    port's own card reading (`quality.PORT_R03_FINAL`), its untrained
    reading at iteration 0 (the control) missing both."""
    from vegs_torch.perf import quality as q

    t0 = time.perf_counter()
    counters = all_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    rec = q.run_r03(device=dev, log=lambda m: None)
    launches = {k: c.launches for k, c in counters.items()}
    rows = q.held_legacy({"r03": rec}, q.PSNR_BAND_DB)
    res = {"r03": rec, "launches": launches, "held": rows,
           "seconds": time.perf_counter() - t0}
    emit("legacy_quality", run="r03", card=card, trend=rec["trend"],
         err_trend=rec["err_trend"], err_raw=rec["err_raw"],
         guided_iters=rec["guided_iters"],
         ms_per_step_median=rec["ms_per_step_median"], wall_s=rec["wall_s"],
         kcap_path=rec["kcap_path"], launches=launches,
         jax_final=q.JAX_R03[q.R03_ITERS][0],
         port_final=q.PORT_R03_FINAL, psnr_band=q.PSNR_BAND_DB,
         held=[{"held": r[0], "port": r[1], "reference": r[2],
                "band": r[3], "within": r[4]} for r in rows],
         seconds=res["seconds"])
    missed = [r for r in rows if not r[4]]
    if missed:
        raise AssertionError(f"r03 misses {missed} (the last row is the "
                             "untrained control: if it holds, the check is "
                             "too loose)")
    short = [k for k in ("K1", "K2", "K3") if launches[k] < q.R03_ITERS]
    if short or launches["M1"] or launches["M2"]:
        raise AssertionError(f"r03 launches {launches}")
    return res


def kernel_times(kernel, plain, library) -> dict:
    """The card's own ms per call (torch.profiler: the summed durations of
    the device operations each call launches, without host gaps) of a
    kernel's wrapper, its plain version and the library call, and the
    kernel's stream ms (CUDA events, host gaps included). A kernel of a few
    tens of microseconds behind a Python wrapper is timed by the former:
    between launches the stream waits on the host. "device_sources" says,
    for the three, whether the profiler or `timing.queued_ms` (the
    fallback where the profiler recorded nothing) gave the time."""
    from vegs_torch.perf.timing import (DEVICE_OVER_STREAM, cuda_ms,
                                        device_profile)

    k, p, lib = (device_profile(fn) for fn in (kernel, plain, library))
    t = {"ms": k["device_ms"], "stream_ms": cuda_ms(kernel),
         "plain_ms": p["device_ms"], "library_ms": lib["device_ms"],
         "device_sources": [x["device_source"] for x in (k, p, lib)]}
    if t["ms"] > DEVICE_OVER_STREAM * t["stream_ms"]:
        raise AssertionError(f"device time over stream time: {t}")
    return t


def m2_check(data, card) -> dict:
    """M2 against its plain version on the probes' inputs ([K, 8] f32,
    [K, 16] bf16): bit-identical; card, plain, library (x.t().contiguous())
    and bound times. Returns the f32 case's line."""
    from vegs_torch.perf import micro3, roofline

    lines = []
    for name, x in (("f32", data.a8), ("bf16", data.a16)):
        got = micro3.transpose(x)
        ref = micro3.transpose_ref(x)
        bits = torch.int32 if x.element_size() == 4 else torch.int16
        ident = bool(torch.equal(got.view(bits), ref.view(bits)))
        b_ms, by = roofline.bound_ms(
            roofline.Work(2 * x.numel() * x.element_size(), 0))
        line = {"dtype": name, "shape": list(x.shape), "bit_identical": ident,
                "max_abs_err": float((got.float() - ref.float()).abs().max()),
                **kernel_times(lambda: micro3.transpose(x),
                               lambda: micro3.transpose_ref(x),
                               lambda: x.t().contiguous()),
                "bound_ms": b_ms, "bound_by": by}
        emit("m2_check", card=card, **line)
        if not ident:
            raise AssertionError(f"M2 differs from its plain version: {line}")
        lines.append(line)
    return lines[0]


def m1_check(data, card) -> dict:
    """M1 against its plain version on the probes' inputs, f32 and bf16,
    [K, C] and [C, K]: |d| <= M1_RTOL * sum|x|, the control (the last
    2^17-long block left out) outside it, two runs bit-identical; card,
    plain, library (torch.sum in f32) and bound times. Returns the f32
    [K, C] case's line, with the largest |d| of all cases."""
    from vegs_torch.perf import micro3, roofline

    lines = []
    for name, x in (("f32", data.a8), ("bf16", data.a16)):
        for layout, y in (("[K, C]", x), ("[C, K]", x.t().contiguous())):
            got = micro3.psum_consume(y)
            again = micro3.psum_consume(y)
            parts = micro3.psum_parts_ref(y)
            ref = float(parts.sum())
            mag = float(y.float().abs().sum())
            d = abs(float(got) - ref)
            b_ms, by = roofline.bound_ms(roofline.Work(
                y.numel() * y.element_size(), y.numel()))
            line = {"dtype": name, "layout": layout, "shape": list(y.shape),
                    "value": float(got), "plain_value": ref, "abs_sum": mag,
                    "max_abs_err": d, "reading": d / mag,
                    "control_reading": abs(float(parts[:-1].sum()) - ref) / mag,
                    "limit": M1_RTOL,
                    "repeatable": bool(torch.equal(got, again)),
                    **kernel_times(
                        lambda: micro3.psum_consume(y),
                        lambda: micro3.psum_consume_ref(y),
                        lambda: torch.sum(y, dtype=torch.float32)),
                    "bound_ms": b_ms, "bound_by": by}
            emit("m1_check", card=card, **line)
            hold(f"M1 {name} {layout}", line["reading"], M1_RTOL,
                 line["control_reading"])
            if not line["repeatable"]:
                raise AssertionError(f"M1 differs between two runs: {line}")
            lines.append(line)
    return {**lines[0], "max_abs_err": max(ln["max_abs_err"] for ln in lines)}


def perf_phase(dev, card) -> dict:
    """The measurement path (see phase 16). Returns the M1 and M2 check
    lines and the launches of every kernel in the path."""
    from vegs_torch.perf import micro3, refscale, roofline

    t0 = time.perf_counter()
    data = micro3.make_data(dev)
    res = {"M2": m2_check(data, card), "M1": m1_check(data, card)}
    counters = all_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    micro3.run(device=dev, data=data,
               emit=lambda **kw: emit("micro3", **kw))
    del data
    rs = refscale.run(device=dev, work=True,
                      emit=lambda **kw: emit("refscale", **kw))
    res["launches"] = {k: c.launches for k, c in counters.items()}
    roofline.table(rs, emit=lambda **kw: emit("roofline", **kw))
    emit("perf", launches=res["launches"], counts=rs["counts"],
         seconds=time.perf_counter() - t0, card=card)
    missing = [k for k, v in res["launches"].items() if not v]
    if missing:
        raise AssertionError(f"the perf path never launched {missing}")
    return res


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of vegs_torch on "
                                 "one CUDA card (see the module docstring).")
    ap.add_argument("--quality-out", default=None, metavar="PATH",
                    help="also write the quality phase's readings into "
                         "this quality report (vegs_torch.perf.quality's "
                         "QUALITY_TORCH.md format)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (HERE / "vegs_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a vegs checkout "
              "(vegs_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vegs_torch import kernels
    from vegs_torch.config import ModelParams
    from vegs_torch.ops import blend_cuda, satcull, segreduce
    from vegs_torch.ops.rasterize import (RasterizeConfig,
                                          SAT_MIN_SLOTS_PER_TILE, stage)
    from vegs_torch.perf import roofline
    from vegs_torch.perf.refscale import origin_camera, random_gaussians
    from vegs_torch.perf.timing import card_line, cuda_ms
    from vegs_torch.render import render
    from vegs_torch.render_video import (DEFAULT_AUG_PARAMS, interpolate_cameras,
                                         render_frames)
    from vegs_torch.scene import Scene
    from vegs_torch.scene.cameras import make_camera_like_input_camera
    from vegs_torch.scene.dataset_readers import SceneInfo, getNerfppNorm
    from vegs_torch.utils.synthetic import street_camera_infos

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit("device", kind=kind, card=card, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    b = kernels.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "smem" in ln]
             for name, log in b["ptxas"].items()}
    occupancy = {f"{lib} {dt}": blend_cuda.kernel_info(lib, dt, 256)
                 for lib in ("blend_fwd", "blend_bwd")
                 for dt in (torch.bfloat16, torch.float32)}
    occupancy["satcount"] = satcull.kernel_info(256)
    occupancy.update({f"segreduce {dt}": segreduce.kernel_info(dt)
                      for dt in (torch.bfloat16, torch.float32)})
    wide = {f"blend_bwd {dt} {px} pixels": blend_cuda.kernel_info(
        "blend_bwd", dt, px) for px in (512, 1024)
        for dt in (torch.bfloat16, torch.float32)}
    emit("build", seconds=b["seconds"], built=b["built"], ptxas=ptxas,
         occupancy_16x16=occupancy, occupancy_wide_tiles=wide,
         dir=str(kernels.build_dir().relative_to(HERE)))

    # -- 3. K4 at a saturating reduced scene --------------------------------
    rng = np.random.default_rng(SEED)
    small_cam = origin_camera(128, 512, 1.0, 0.3, dev)
    arrs = [torch.from_numpy(x).to(dev) for x in random_gaussians(
        rng, 60_000, (1.5, 10.0), 3.0, (0.1, 0.6), (0.5, 0.99))]
    cfg = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP, sat_cull=True,
                          forward_only=True)
    st = stage(*arrs, small_cam, config=cfg)
    cfg = cfg._replace(k_cap=r512(int(st.rb.total) * 1.05),
                       k_pad=r512(int(st.binned.tile_starts[-1]) * 1.05))
    st = stage(*arrs, small_cam, config=cfg)
    if int(st.binned.num_dropped):
        raise AssertionError("reduced K4 scene drops instances")
    k4_small = compare_k4(st)
    emit("k4_check", scene="128x512, 60k Gaussians", card=card, **k4_small)

    # -- 4. K1 at a reduced scene, f32 and bf16 aux ------------------------
    arrs = [torch.from_numpy(x).to(dev) for x in random_gaussians(
        rng, 30_000, (1.5, 10.0), 3.0, (0.03, 0.3))]
    k1_small = {}
    for aux in ("f32", "bf16"):
        cfg = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP,
                              payload_dtype=aux, forward_only=True)
        st = stage(*arrs, small_cam, config=cfg)
        cfg = cfg._replace(k_cap=r512(int(st.rb.total) * 1.05),
                           k_pad=r512(int(st.binned.tile_starts[-1]) * 1.05))
        st = stage(*arrs, small_cam, config=cfg)
        k1_small[aux] = compare_k1(st)
        emit("k1_check", scene="128x512, 30k Gaussians", aux=aux, card=card,
             **k1_small[aux])

    # -- 5. the main path at full width -------------------------------------
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        write_field_ply(Path(model_dir) / "point_cloud" / "iteration_1"
                        / "point_cloud.ply", N_REF, SEED)
        infos = street_camera_infos(3, H, W, fovx=1.2, fovy=0.4)
        info = SceneInfo(point_cloud=None, train_cameras=infos, test_cameras=[],
                         nerf_normalization=getNerfppNorm(infos), ply_path="")
        scene = Scene(ModelParams(model_path=model_dir), scene_info=info,
                      load_iteration=-1, shuffle=False, device=dev)
        setup_s = time.perf_counter() - t0
    n_interp, max_frames = 4, 3
    cams = interpolate_cameras(scene.getTrainCameras(), n_interp)[:max_frames]
    views = [make_camera_like_input_camera(c, **a)
             for a in DEFAULT_AUG_PARAMS for c in cams]
    with torch.inference_mode():
        cfg, need_raw, need_pad = sized_config(scene.gaussians, views, dev)
        if cfg.k_cap < SAT_MIN_SLOTS_PER_TILE * 2112:
            raise AssertionError("the sat-cull gate should be on at this scale")
        for v in views:  # the capacities drop nothing on any frame
            nd = int(field_stage(scene.gaussians, v.device_params(dev),
                                 cfg._replace(forward_only=True)).binned.num_dropped)
            if nd:
                raise AssertionError(f"{nd} instances dropped at {cfg}")
        # warm the allocator and the libraries on one frame
        render(views[0], scene.gaussians, config=cfg._replace(forward_only=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = main_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    frames = render_frames(scene, n_interp=n_interp, max_frames=max_frames,
                           raster_cfg=cfg)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    render_launches = {k: counters[k].launches for k in ("K1", "K4")}
    peak_mem = torch.cuda.max_memory_allocated()
    n_frames = sum(len(f) for f in frames.values())
    if n_frames < 8:
        raise AssertionError(f"only {n_frames} frames rendered")
    for name, fr in frames.items():
        for f in fr:
            if f.shape != (H, W, 3) or not np.isfinite(f).all():
                raise AssertionError(f"{name}: bad frame {f.shape}")
            if f.min() < 0 or f.max() > 1:
                raise AssertionError(f"{name}: frame outside [0, 1]")
    if min(render_launches.values()) < n_frames:
        raise AssertionError(f"kernel launches {render_launches} < "
                             f"{n_frames} frames")
    emit("main", frames=n_frames, trajectories=list(frames), n=N_REF,
         capacity=scene.gaussians.capacity, k_cap=cfg.k_cap, k_pad=cfg.k_pad,
         need_raw=need_raw, need_pad=need_pad, launches=render_launches,
         frame_mean=[float(np.mean(f[0])) for f in frames.values()],
         setup_s=setup_s, card=card)

    # sat cull on vs off on one frame: bit-identical, and coverage
    view = views[0]
    with torch.inference_mode():
        probe_off = RasterizeConfig(k_cap=PROBE_CAP, k_pad=PROBE_CAP,
                                    sat_cull=False, forward_only=True)
        need_off = int(field_stage(scene.gaussians, view.device_params(dev),
                                   probe_off).binned.tile_starts[-1])
        on = render(view, scene.gaussians,
                    config=cfg._replace(forward_only=True, sat_cull=True))
        off = render(view, scene.gaussians,
                     config=cfg._replace(forward_only=True, sat_cull=False,
                                         k_pad=r512(need_off * 1.05)))
        ident = {k: bool(torch.equal(getattr(on, k), getattr(off, k)))
                 for k in ("rgb", "depth", "alpha")}
        dropped = (int(on.num_dropped), int(off.num_dropped))
        coverage = float((on.alpha > 0.5).float().mean())
    emit("satcull_lossless", bit_identical=ident, num_dropped=dropped,
         padded_slots={"on": int(on.num_needed), "off": int(off.num_needed)},
         alpha_coverage=coverage, card=card)
    if not all(ident.values()) or any(dropped):
        raise AssertionError("sat cull on/off renders differ or drop")
    if coverage < 0.5:
        raise AssertionError(f"alpha coverage {coverage} is trivial")

    # kernels against their plain versions on this frame's inputs
    with torch.inference_mode():
        st = field_stage(scene.gaussians, view.device_params(dev),
                         cfg._replace(forward_only=True))
        k4_full = compare_k4(st)
        emit("k4_check", scene="376x1408, 2,233,571 Gaussians", card=card,
             **k4_full)
        k1_full = compare_k1(st)
        emit("k1_check", scene="376x1408, 2,233,571 Gaussians", aux="bf16",
             card=card, **k1_full)
        k1c = k1_cull(st)
        emit("k1_cull", scene="376x1408, 2,233,571 Gaussians", aux="bf16",
             card=card, **k1c)
        k4c = k4_cull(st)
        emit("k4_cull", scene="376x1408, 2,233,571 Gaussians, first frame",
             card=card, **k4c)
        k4g = k4_gather(st)
        emit("k4_gather", scene="376x1408, 2,233,571 Gaussians, first frame",
             card=card, **k4g)

        # -- 6. timing at the full-width shapes --------------------------------
        grid = st.grid
        hp, wp = grid.padded_height, grid.padded_width
        ts = st.binned.tile_starts
        k1_ms = cuda_ms(lambda: blend_cuda.blend(
            st.payload_f32, st.payload_aux, ts, grid, hp, wp))
        k4_ms = cuda_ms(lambda: satcull.satcount_gathered(*k4_args(st)))
        # bounds: the work this frame's inputs need, from the plain
        # versions' records
        k1_pairs, k4_pairs = {}, {}
        blend_cuda.blend_ref_tiles(st.payload_f32, st.payload_aux, ts, grid,
                                   hp, wp, pairs=k1_pairs)
        satcull.satcount_gathered_ref(*k4_args(st), pairs=k4_pairs)
        k1_bytes, k1_ops = roofline.k1_work(
            k1_pairs, st.payload_aux.element_size(), grid.num_tiles, hp, wp)
        k4_bytes, k4_ops = roofline.k4_work(k4_pairs, grid.num_tiles)

    k1_bound, k1_by = roofline.bound_ms(roofline.Work(k1_bytes, k1_ops))
    k4_bound, k4_by = roofline.bound_ms(roofline.Work(k4_bytes, k4_ops))
    emit("timing", card=card, kind=kind,
         ms_per_frame=main_s / n_frames * 1e3,
         k1_ms=k1_ms, k4_ms=k4_ms,
         k1_plain_ms=k1_full["plain_ms"], k4_plain_ms=k4_full["plain_ms"],
         k1_plain_ms_reduced={a: r["plain_ms"] for a, r in k1_small.items()},
         k4_plain_ms_reduced=k4_small["plain_ms"],
         k1_bound_ms=k1_bound, k1_bound_by=k1_by, k1_pairs=k1_pairs,
         k1_ops=k1_ops, k1_bytes=k1_bytes, k4_bound_ms=k4_bound,
         k4_bound_by=k4_by, k4_pairs=k4_pairs, k4_ops=k4_ops,
         k4_bytes=k4_bytes,
         max_memory_allocated=peak_mem)

    # where a frame's time goes: 4 frames (one per trajectory) under the
    # profiler, after the main path (the profiler's cost is not in the
    # per-frame time above)
    def four_frames():
        with torch.inference_mode():
            for a in DEFAULT_AUG_PARAMS:
                v = make_camera_like_input_camera(cams[1], **a)
                render(v, scene.gaussians,
                       config=cfg._replace(forward_only=True)).rgb.cpu()

    emit("profile", card=card, frames=len(DEFAULT_AUG_PARAMS),
         **profile_frames(four_frames))

    # -- 7. the training path at full width ---------------------------------
    train = train_phase(scene, dev, card)

    # -- 8. K2, K3 and K4 on the first step's inputs --------------------------
    k2_args, k3_args = train.pop("k2_args"), train.pop("k3_args")
    step_st = train.pop("k4_st")
    k4c_step = k4_cull(step_st)
    emit("k4_cull", scene="376x1408, 2,233,571 Gaussians, first train step",
         card=card, **k4c_step)
    k2 = compare_k2(k2_args)
    k2_ms = cuda_ms(lambda: blend_cuda.blend_bwd(*k2_args))
    pf, pa, ts2, out2, dout2, grid2 = k2_args
    hp2, wp2 = grid2.padded_height, grid2.padded_width
    k2_bytes, k2_ops = roofline.k2_work(k2["pairs"], pa.element_size(),
                                        pf.shape[1], grid2.num_tiles, hp2, wp2)
    k2_bound, k2_by = roofline.bound_ms(roofline.Work(k2_bytes, k2_ops))
    emit("k2_check", scene="376x1408, 2,233,571 Gaussians, first train step",
         aux=str(pa.dtype), card=card, ms=k2_ms, bound_ms=k2_bound,
         bound_by=k2_by, ops=k2_ops, bytes=k2_bytes,
         limit=K2_RTOL, held=K2_SCALE, **k2)
    for rows, scale in K2_SCALE.items():
        hold(f"K2 {rows} by {scale}", k2[rows]["reading"][scale], K2_RTOL,
             k2[rows]["control_reading"][scale])
    if k2["flip_tiles"] > K2_MAX_FLIP_TILES * grid2.num_tiles:
        raise AssertionError(f"K2: {k2['flip_tiles']} stop-flip tiles")
    k2c = k2_cull(k2_args)
    emit("k2_cull", scene="376x1408, 2,233,571 Gaussians, first train step",
         aux=str(pa.dtype), card=card, **k2c)
    k2x = k2_float64(k2_args)
    emit("k2_f64", scene="376x1408, 2,233,571 Gaussians, first train step",
         aux=str(pa.dtype), card=card, limit=K2_F64_RTOL, held="group", **k2x)
    hold("K2 deep f32 rows against float64", k2x["kernel"]["group"],
         K2_F64_RTOL, k2x["control"]["group"])

    # K3 as the main path runs it: the gather's whole backward
    gidx = step_st.binned.gidx
    k3f = compare_k3_fused(k3_args, step_st)
    k3_ms = cuda_ms(lambda: segreduce.gather_expand_bwd(*k3_args))
    d_pf, d_pa, order, ends = k3_args
    k3_lib = k3_library(step_st.pay_rows, d_pa.dtype, gidx)
    k3_lib_ms = cuda_ms(lambda: k3_lib(d_pf, d_pa))
    k3_index_add_ms = cuda_ms(lambda: k3_index_add(d_pf, d_pa, gidx,
                                                   ends.shape[0]))
    del k3_lib
    k3f_bytes, k3f_ops = roofline.k3_fused_work(k3f["rows"], ends.shape[0],
                                                d_pa.element_size())
    k3f_bound, k3f_by = roofline.bound_ms(roofline.Work(k3f_bytes, k3f_ops))
    k3_ways = gather_bwd_times(k3_args)
    emit("k3_fused", scene="376x1408, 2,233,571 Gaussians, first train step",
         card=card, ms=k3_ms, bound_ms=k3f_bound, bound_by=k3f_by,
         bytes=k3f_bytes, ops=k3f_ops, limit=K3_RTOL, library_ms=k3_lib_ms,
         index_add_ms=k3_index_add_ms, spans=segreduce.span_stats(ends),
         gather_bwd=k3_ways, **k3f)
    for rows in ("f32_rows", "aux_rows"):
        hold(f"K3 fused {rows}", k3f[rows]["reading"], K3_RTOL,
             k3f[rows]["control_reading"])
        hold(f"K3 library {rows}", k3f[rows]["library_reading"], K3_RTOL)

    # K3 in the JAX contract, on the columns the fused kernel no longer needs
    k3c_args = segreduce.cotangent_columns(*k3_args)
    k3 = compare_k3(*k3c_args)
    cols, starts, ends = k3c_args
    k3c_ms = cuda_ms(lambda: segreduce.segment_reduce_cols(*k3c_args))
    total = int(ends[-1])
    k3c_lib = k3_contract_library(*k3c_args)
    lib_err = float((k3c_lib() - segreduce.segment_reduce_cols(*k3c_args)
                     ).abs().max())
    k3c_lib_ms = cuda_ms(k3c_lib)
    k3_bytes, k3_ops = roofline.k3_work(cols.shape[0], total, starts.shape[0])
    k3_bound, k3_by = roofline.bound_ms(roofline.Work(k3_bytes, k3_ops))
    emit("k3_check", scene="376x1408, 2,233,571 Gaussians, first train step",
         card=card, ms=k3c_ms, library_ms=k3c_lib_ms,
         library_max_abs_err=lib_err, bound_ms=k3_bound, bound_by=k3_by,
         bytes=k3_bytes, ops=k3_ops, limit=K3_RTOL, **k3)
    hold("K3", k3["reading"], K3_RTOL, k3["control_reading"])
    k3_contract = {"ms": k3c_ms, "plain_ms": k3["plain_ms"],
                   "bound_ms": k3_bound, "bound_by": k3_by,
                   "library_ms": k3c_lib_ms, "max_abs_err": k3["max_abs_err"]}
    del k2_args, k3_args, k3c_args, cols, k3c_lib, step_st, gidx

    # -- 9. one step's gradients: kernels against plain versions -------------
    grad = grad_check(dev)
    emit("grad_check", card=card, limit=GRAD_RTOL, **grad)
    hold("step gradients", grad["reading"], GRAD_RTOL,
         grad["control_reading"])
    hold("step gradients, box and delta leaves", grad["box_reading"],
         GRAD_RTOL, grad["box_control_reading"])
    hold("step gradients, box colour leaves", grad["colour_reading"],
         GRAD_RTOL, grad["colour_control_reading"])
    hold("box colour rows one bf16 step from the plain version's",
         grad["colour_flip_share"], COLOUR_MAX_FLIP_SHARE,
         grad["colour_control_flip_share"])

    del views, frames, st, on, off
    torch.cuda.empty_cache()

    # -- 9b. wide tiles (16x32, 32x16, 32x32) through the main path ------------
    tiles = tiles_phase(dev, card, scene)
    del scene
    torch.cuda.empty_cache()

    # -- 10. the dynamic-scene training path at full width ---------------------
    boxes = boxes_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 11-12. the training CLI from a KITTI-360 segment on disk, then the
    # offline tools on that segment and its trained model ------------------
    with tempfile.TemporaryDirectory() as seg_dir:
        cli = cli_phase(dev, card, Path(seg_dir))
        torch.cuda.empty_cache()
        tools = tools_phase(dev, card, Path(seg_dir), cli)
        torch.cuda.empty_cache()

    # -- 13. the diffusion-guided training step at full width ---------------
    guide = guide_phase(dev, card)
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    # -- 14. multi-device training at full width ----------------------------
    par = parallel_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 15. the end-to-end quality run: arm A trained 1,500 iterations -----
    quality = quality_phase(dev, card)
    if args.quality_out:
        from vegs_torch.perf.quality import write_report

        write_report(args.quality_out, "smoke", {
            k: quality[k] for k in ("arm_a", "control", "control_bf16",
                                    "phase_s", "setting")})
    torch.cuda.empty_cache()

    # -- 16. the fully sharded trainer's quality runs, D = 4 on the card ----
    tpq = tp_quality_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 17. the measurement path, on a card freed of the earlier phases ----
    perf = perf_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 17b. the main path's probes at bench shape --------------------------
    probes = probes_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 17c. the glue and gather-backward probes, the backward bisect, the
    # sharded-path check -----------------------------------------------------
    micro = micro_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 17d. the superseded r03 quality run in full --------------------------
    legacy = legacy_quality_phase(dev, card)
    if args.quality_out:
        from vegs_torch.perf.quality import write_report

        write_report(args.quality_out, "r03", legacy["r03"])

    # -- 18. summary ---------------------------------------------------------
    launches = {**train["launches"]}
    m1, m2 = perf["M1"], perf["M2"]
    # launches: the static train phase's 8 steps; launches_boxes: the
    # boxes phase's 8 steps; launches_cli: the cli phase's two `main` runs
    # (24 + 12 steps, their reports); launches_tools: the tools phase's
    # `render_sets` (4 trajectories x TOOLS_VIDEO_FRAMES frames);
    # launches_guide: the guide phase's 12 guided steps (two renders each);
    # launches_parallel: the parallel phase's DP and TP steps and sharded
    # renders, D = 1 and both D = 2 ranks; launches_quality: the quality
    # phase's arm A (1,500 steps and its evaluations); launches_tp_quality:
    # the tp_quality phase's TP steps, every rank of both runs;
    # launches_tiles: the tiles phase's three Trainer steps and three
    # fwd+bwd (one a wide shape; its sweep is not counted); launches_probes:
    # the probes phase's stage split, bisect, binning probes, sat-cull
    # analysis and debug trails; launches_micro: the micro phase's probes,
    # backward bisect and sharded-path check (K3's JAX-contract entry in
    # its jax_contract); launches_legacy_quality: r03's 1,000 steps and
    # their evaluations
    perf_only = "the perf phase (micro3 probes); the main paths never launch it"
    print(json.dumps({"kernels": [
        {"name": "K1 blend_fwd", "route": "cuda",
         "source": "vegs_torch/csrc/blend_fwd.cu",
         "replaces": "vegs_tpu/ops/blend_pallas.py:201",
         "launches": launches["K1"],
         "launches_boxes": boxes["launches"]["K1"],
         "launches_cli": cli["launches"]["K1"],
         "launches_tools": tools["launches"]["K1"],
         "launches_guide": guide["launches"]["K1"],
         "launches_parallel": par["launches"]["K1"],
         "launches_quality": quality["launches"]["K1"],
         "launches_tp_quality": tpq["launches"]["K1"],
         "launches_tiles": tiles["launches"]["K1"],
         "launches_probes": probes["launches"]["K1"],
         "launches_micro": micro["launches"]["K1"],
         "launches_legacy_quality": legacy["launches"]["K1"],
         "matches_plain": True,
         "max_abs_err": k1_full["max_abs_err"],
         "stop_flips": k1_full["stop_flips"],
         "ms": k1_ms, "plain_ms": k1_full["plain_ms"],
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "ms_nocull": k1c["ms_nocull"],
         "cull_skipped_share": k1c["pairs"]["skipped_share"]},
        {"name": "K2 blend_bwd", "route": "cuda",
         "source": "vegs_torch/csrc/blend_bwd.cu",
         "replaces": "vegs_tpu/ops/blend_pallas.py:274",
         "launches": launches["K2"],
         "launches_boxes": boxes["launches"]["K2"],
         "launches_cli": cli["launches"]["K2"],
         "launches_tools": tools["launches"]["K2"],
         "launches_guide": guide["launches"]["K2"],
         "launches_parallel": par["launches"]["K2"],
         "launches_quality": quality["launches"]["K2"],
         "launches_tp_quality": tpq["launches"]["K2"],
         "launches_tiles": tiles["launches"]["K2"],
         "launches_probes": probes["launches"]["K2"],
         "launches_micro": micro["launches"]["K2"],
         "launches_legacy_quality": legacy["launches"]["K2"],
         "matches_plain": True,
         "max_abs_err": k2["max_abs_err"],
         "reading": max(k2[rows]["reading"][scale]
                        for rows, scale in K2_SCALE.items()),
         "flip_tiles": k2["flip_tiles"],
         "ms": k2_ms, "plain_ms": k2["plain_ms"],
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "ms_nocull": k2c["ms_nocull"],
         "cull_skipped_share": k2c["pairs"]["skipped_share"],
         "tile": "16x16",
         "tiles": {shape: {
             "ms": x["k2"]["ms"], "bound_ms": x["k2"]["bound_ms"],
             "bound_by": x["k2"]["bound_by"],
             "launches": x["launches"]["K2"]
             + tiles["steps"][shape]["launches"]["K2"],
             "max_abs_err": x["k2"]["max_abs_err"],
             "reading": max(x["k2"][rows]["reading"][scale]
                            for rows, scale in K2_SCALE.items()),
             "tiles_held": x["k2"]["tiles_held"],
             "plain_ms_held_tiles": x["k2"]["plain_ms_held_tiles"],
             "bit_identical_rerun": x["k2"]["bit_identical_rerun"],
             "scene": f"{TILES_N:,} Gaussians, 376x1408"}
             for shape, x in tiles["shapes"].items()}},
        {"name": "K3 segreduce", "route": "cuda",
         "source": "vegs_torch/csrc/segreduce.cu",
         "replaces": "vegs_tpu/ops/segreduce.py:46",
         "launches": launches["K3"],
         "launches_boxes": boxes["launches"]["K3"],
         "launches_cli": cli["launches"]["K3"],
         "launches_tools": tools["launches"]["K3"],
         "launches_guide": guide["launches"]["K3"],
         "launches_parallel": par["launches"]["K3"],
         "launches_quality": quality["launches"]["K3"],
         "launches_tp_quality": tpq["launches"]["K3"],
         "launches_tiles": tiles["launches"]["K3"],
         "launches_probes": probes["launches"]["K3"],
         "launches_micro": micro["launches"]["K3"],
         "launches_legacy_quality": legacy["launches"]["K3"],
         "matches_plain": True,
         "entry": "gather_expand_bwd (the gather's whole backward)",
         "max_abs_err": k3f["max_abs_err"],
         "reading": max(k3f[r]["reading"] for r in ("f32_rows", "aux_rows")),
         "ms": k3_ms, "plain_ms": k3f["plain_ms"],
         "bound_ms": k3f_bound, "bound_by": k3f_by, "library_ms": k3_lib_ms,
         "library": "autograd's own backward of pay[gidx].T.contiguous() "
                    "(accumulating index_put_ on the row-major tables)",
         "index_add_ms": k3_index_add_ms,
         "device_ms_columns_path": k3_ways["columns"]["device_ms"],
         "jax_contract": {
             **k3_contract, "launches_micro": micro["launches"][
                 "K3 JAX contract"],
             "bench_shape": {k: micro["k3_contract"][k] for k in (
                 "ms", "stream_ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by", "max_abs_err", "reading", "control_reading",
                 "segments", "columns")}},
         "r05_fused": {r: micro["k3_fused"][r]["reading"]
                       for r in ("f32_rows", "aux_rows")}},
        {"name": "K4 satcount", "route": "cuda",
         "source": "vegs_torch/csrc/satcount.cu",
         "replaces": "vegs_tpu/ops/satcull.py:65",
         "launches": launches["K4"],
         "launches_boxes": boxes["launches"]["K4"],
         "launches_cli": cli["launches"]["K4"],
         "launches_tools": tools["launches"]["K4"],
         "launches_guide": guide["launches"]["K4"],
         "launches_parallel": par["launches"]["K4"],
         "launches_quality": quality["launches"]["K4"],
         "launches_tp_quality": tpq["launches"]["K4"],
         "launches_tiles": tiles["launches"]["K4"],
         "launches_probes": probes["launches"]["K4"],
         "launches_micro": micro["launches"]["K4"],
         "launches_legacy_quality": legacy["launches"]["K4"],
         "matches_plain": True,
         "max_abs_err": k4_full["max_abs_err"],
         "ms": k4_ms, "plain_ms": k4_full["plain_ms"],
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None,
         "ms_nocull": k4c["ms_nocull"],
         "cull_skipped_share": k4c["pairs"]["skipped_share"],
         "old_path_ms": k4g["old_path_ms"], "new_path_ms": k4g["new_path_ms"]},
        {"name": "M1 blocksum", "route": "cuda",
         "source": "vegs_torch/csrc/blocksum.cu",
         "replaces": "perf/micro3_r02.py:56",
         "launches": perf["launches"]["M1"], "launched_by": perf_only,
         "launches_guide": guide["launches"]["M1"],
         "launches_tools": tools["launches"]["M1"],
         "launches_quality": quality["launches"]["M1"],
         "launches_tp_quality": tpq["launches"]["M1"],
         "launches_tiles": tiles["launches"]["M1"],
         "launches_probes": probes["launches"]["M1"],
         "launches_micro": micro["launches"]["M1"],
         "launches_legacy_quality": legacy["launches"]["M1"],
         "matches_plain": True, "max_abs_err": m1["max_abs_err"],
         "case": f"{m1['dtype']} {m1['layout']}",
         "ms": m1["ms"], "plain_ms": m1["plain_ms"],
         "bound_ms": m1["bound_ms"], "bound_by": m1["bound_by"],
         "library_ms": m1["library_ms"]},
        {"name": "M2 transpose", "route": "cuda",
         "source": "vegs_torch/csrc/transpose.cu",
         "replaces": "perf/micro3_r02.py:107",
         "launches": perf["launches"]["M2"], "launched_by": perf_only,
         "launches_guide": guide["launches"]["M2"],
         "launches_tools": tools["launches"]["M2"],
         "launches_quality": quality["launches"]["M2"],
         "launches_tp_quality": tpq["launches"]["M2"],
         "launches_tiles": tiles["launches"]["M2"],
         "launches_probes": probes["launches"]["M2"],
         "launches_micro": micro["launches"]["M2"],
         "launches_legacy_quality": legacy["launches"]["M2"],
         "matches_plain": True, "max_abs_err": m2["max_abs_err"],
         "case": m2["dtype"],
         "ms": m2["ms"], "plain_ms": m2["plain_ms"],
         "bound_ms": m2["bound_ms"], "bound_by": m2["bound_by"],
         "library_ms": m2["library_ms"]},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
