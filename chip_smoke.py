#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (mapping_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an NVIDIA Hopper
card, the CUDA toolkit (nvcc) and PyTorch built for CUDA; neither JAX nor
the JAX package is imported. Phases, each printing what it found:

  1. the card: refuses to run without CUDA; prints the card's name and
     power limit as nvidia-smi gives them;
  2. build: compiles mapping_tpu_torch/csrc/ccl.cu, conv_dw.cu and
     jpeg_pixels.cu for sm_90a into build/, one nvcc per source, started
     together (and the parent tree's sources when a copy of it lies under
     build/old/); fails if `-Xptxas -v` reports a spill; beside them
     csrc/jp2_decode.cpp with g++ -ffp-contract=off, then
     csrc/jpeg_entropy.cpp with g++;
  3. kernels: the CUDA CCL kernels (K1 `label_raw`, K2 `renumber` and the
     fused `label`) against their plain PyTorch versions and
     scipy.ndimage.label, exact, on test cases, serving shapes, lines and
     shapes on K1's tile borders and corners, and a (1, 3, 70000) row; the
     CUDA kernels one connected_components call launches, with each one's
     device time, from a torch.profiler trace; then times at (20, 300,
     300) noise of density 0.5: kernel, plain, torch.unique's inverse as a
     yardstick for the renumbering, and the parent tree's kernels (K1, K2
     and K1 + K2) where present. K1 and `label` are timed the same way on
     phase 4's serving masks, on phase 8's masks and building footprints,
     and on phase 10's 19-layer masks; each mask batch is saved under
     build/ccl_masks/ for
     `python3 -m mapping_tpu_torch.tools.kernel_variants ccl`;
  4. slice: a ResNet101 UNetPipeline (32 filters, deconv, BN folded,
     bfloat16, random weights from a seeded torch.Generator) serves 3
     batches of 20 uint8 300^2 tiles through `transform`; the CCL launch
     counts of that run must be above 0, the kernel path must equal the
     plain path on the same probabilities, a float32 pipeline on the card
     must agree with a float32 forward on the CPU, and one batch of dense
     probabilities must go through the overflow escalation;
  5. conv_dw: the CUDA filter-gradient kernel against its plain PyTorch
     version (max |kernel - plain| <= 1e-4 max |plain|) on k = 3 with
     C = 32, 64, 128, k = 5, a batch of 1, H != W and an all-zero dy, and
     bit-identical on a rerun; then kernel, cuDNN's weight gradient and
     plain times at the dW probe's shapes, (64, 32, 256, 256) and
     (64, 64, 128, 128), and the train step's dec0.conv (20, 32, 256, 256)
     and dec1.block.0.conv (20, 128, 128, 128), with the parent tree's
     kernel where present;
  6. prepare: a CrowdAI-style split under build/chip_smoke_prepare/, PNG
     written with the standard library: train holds 700 synthetic 300^2
     tiles (tests/fixtures/synthetic.py `_make_image`, up to 20
     buildings), a crowded tile of 150 small buildings (more than
     MAX_OBJECTS = 128: the chunked path) and a tile without annotations;
     val holds 110 tiles. The CLI (`python3 -m mapping_tpu_torch.main
     prepare_masks`) runs at the JAX defaults (erosion, dilation and border
     0) in a child process: wall time, images/s and the child's peak RSS.
     In this process the same leg over the train split times each
     `connected_components` call (the CUDA `label`) with CUDA events, and
     `overlay_masks` runs on 100 tiles with erosion 3, erosion 3 +
     dilation 2, and border width 2; the CCL launches of these runs must
     be above 0. On 20 tiles (the crowded and the empty one among them),
     in each mode, the files written on the card must equal those of the
     port on the CPU and of the plain CCL swapped in for the kernels
     (masks, sizes and float16 distances exact), and the card's targets
     must match a scipy oracle (the objects' rules applied with
     ndimage filters, distance_transform_edt's top 2): masks and sizes
     exact, distances within 1e-4 relative;
  7. train: a ResNet101 UNetTrainer at the JAX config's defaults (bf16,
     batch 20, 256^2, weighted loss, Adam with L2 on conv kernels) with
     seeded random weights trains on the files phase 6 wrote, read through
     `prepare_metadata -tr` and SegmentationLoader.transform: one epoch of
     5 augmented batches in `resize` mode (its peak RSS printed), then one
     `crop_and_pad` batch; the losses must be finite, and must fall over 5
     steps on one batch repeated; one float32 step on the card must match
     one on the CPU; the dW kernel, run by the dW probe on the input and
     output gradient of dec0.conv and dec1.block.0.conv captured in a bf16
     step, must match the plain version and autograd's weight gradient;
     the trained weights serve one batch through the pipeline. The
     kernels' launch counts are read from that run;
  8. evaluate: a CrowdAI-style val split of 110 synthetic 300^2 tiles
     (tests/fixtures/synthetic.py `_make_image`, up to 20 buildings), PNG
     written with the standard library, and its COCO annotation.json, under
     build/chip_smoke_evaluate/ (a JPEG of the corpus decodes through the
     port's decoder; a 64-byte fake JPEG raises a ValueError). Seeded random ResNet101 weights saved with
     torch.save come in through `import_checkpoint`; then the CLI
     (`python3 -m mapping_tpu_torch.main`) runs `evaluate -p unet_weighted`
     at the JAX config's defaults in a subprocess, and in this process
     evaluate at the defaults, with erosion 3 and dilation 2, with the
     crop_and_pad loader and reflect padding, and predict_on_dir. Every
     run must write a prediction.json of 300^2 masks for the 110 images
     (the duplicated tail images dropped), AP/AR in [0, 1], and launch the
     CCL kernels (twice as often with erosion on). The postprocess with
     erosion and dilation must give the same labels, areas and scores
     through the kernels as through the plain CCL on the same
     probabilities, and the split's ground truth scored as predictions
     must give AP = AR = 1. Prints the default run's images/s and its
     seconds in decode, on the device, in annotation + RLE and in COCOeval
     (host clock);
  9. train CLI: on phase 6's split (702 train tiles, 110 val), at full
     width (ResNet101, bf16, batch 20, 256^2, weighted loss) and the JAX
     config's defaults but for the number of epochs and the checkpoint
     cadence, four legs through `python3 -m mapping_tpu_torch.main`'s
     entry point, the first three each in a child process that prints its
     CCL launch counts: (a) `train -p unet_weighted`, 2 epochs of all
     train tiles, each validated by COCO mAP on the 110 val tiles through
     FusedServe and the CUDA `label`: wall time, ms/step, each epoch's mAP
     and seconds; unet.pt, best.pt, last.pt with its aux file at epoch 1,
     STAGE_COMPLETE and metrics.jsonl with the JAX package's channels must
     be written, and the losses finite; (b) `train -d` with 4 epochs is
     killed (SIGKILL) once its resume file shows an epoch before the last,
     and the same command run again must resume at the next epoch and end
     at epoch 3 with 4 epochs of optimizer steps in last.pt; (c) `train -w
     -d` with another lr must archive the completed stage
     (checkpoints/unet.stage1, transformers/unet.stage1.pt) and train a
     fresh schedule; (d) in this process, `evaluate -p unet_weighted` on
     leg (a)'s weights must write a prediction.json of the 110 images with
     AP/AR in [0, 1] and launch the CCL kernels;
 10. TTA, padded and scoring pipelines, under build/chip_smoke_scoring/,
     on phase 9 (a)'s weights (random weights find no building to score)
     and phase 6's split: (a) `train -p scoring_model` with
     category_layers [1, 19] in a child process (CLI_CHILD) over 250 of
     the train tiles (the JAX default samples 10,000): wall time,
     feature rows, GBM fit seconds, best_iteration and the child's CCL
     launches; (b) in this process, `evaluate` of unet_tta and unet_padded
     at [1, 1], then unet_scoring_model, unet_padded_scoring_model and
     unet_tta_scoring_model at [1, 19], each on the 110 val tiles: each
     must write a prediction.json of those images with AP/AR in [0, 1] and
     launch the CCL kernels; prints images/s, the stage seconds (the
     scoring runs also their scoring and NMS seconds and how many
     instances NMS suppressed) and peak device memory; (c) on one batch,
     the 19-layer postprocess with the feature tensor gives the same
     labels, areas and features through the kernels as through the plain
     CCL (exact); (d) in float32, the served TTA (12 deduplicated
     forwards) equals the 16-spec stack within 1e-5; (e) K1 and `label`
     are timed on (c)'s 380 masks beside the plain CCL, saved under
     build/ccl_masks/;
 11. serving, under build/chip_smoke_serving/, on phase 9 (a)'s weights,
     phase 10 (a)'s scoring model and phase 6's split: (a) `export -p
     unet_weighted` (serve_batch_buckets "1,4": programs for batches 1, 4
     and 20) and `export -p unet_scoring_model` at [1, 19] (batch 20) in
     one child process: each bucket's export seconds and size, each
     artifact's size; (b) `evaluate --artifact` of both artifacts beside
     the live `evaluate` of the same pipeline on the 110 val tiles, in
     this process: images/s, stage seconds, AP/AR, CCL launches above 0;
     (c) one batch of 20 through the artifact and the live FusedServe:
     the foregrounds may differ only where the live probability lies
     within the measured max |replay - live| probability (an export of
     the same forward) of the threshold, and images without such a pixel
     must have equal labels and areas; each replay launches the CCL once
     (LAUNCHES rises by one), its torch.profiler trace lists the fused
     `label`'s kernels, and its labels equal the plain CCL on the CPU of
     its masks; (d) `serve -p unet_weighted` and `serve --artifact` in
     child processes on free ports: /v1/health within a deadline, the 110
     val tiles POSTed as PNG bytes and as JPEG bytes (the port's encoder,
     quality 95, 4:2:0; their pixel stage runs on the card and the tile
     stays there for the batcher) at concurrency 1 and 16, and one lone
     PNG request; every answer must equal (segmentation exact, scores
     1e-5 relative) that tile's annotations from one of the exported
     batch shapes (the artifact's or the live FusedServe's, on batches of
     exactly that size, of the tile as the body decodes), and
     predict_on_dir's must equal the batch-20 ones; requests/s, p50/p99
     latency (client clock), mean batch occupancy over each run
     (/v1/stats) and each child's CCL and JPEG launches, printed after
     SIGTERM (killed at a 60 s deadline), `jpeg_pixels` above 0;
 12. the model zoo, under build/chip_smoke_zoo/, on phase 6's split
     (phase 9's metadata cut to its first 200 train tiles, the crowded
     and the empty one among them, and the 110 val tiles), seeded random
     weights, the JAX config's defaults (bf16, batch 20, 256^2 in, 300^2
     out): (a) for each of VGG11, VGG16, from_scratch and UNetPlusPlus in
     turn, one child process (ZOO_CHILD) runs `train -p unet_weighted` for
     1 epoch with validation mAP through the CUDA `label`, then `evaluate`
     of that experiment: each must write a prediction.json that
     check_prediction accepts and launch the CCL kernels in both
     commands; prints the parameter count, ms/step, peak device memory
     (and the memory still allocated at the family's start, which the
     peaks include), the evaluate's images/s and stage seconds, AP/AR;
     in this process
     the family's served masks of 20 val tiles (and the same
     probabilities thresholded at their median) go through `label` and
     the plain CCL, which must be equal; (b) UNetMultitask with
     nr_outputs 2 takes 3 train steps with finite losses, and its
     validation, serving and export refuse with MULTI_HEAD; (c) `export`
     of the VGG11 experiment, then `evaluate --artifact`, whose AP/AR
     must equal the live evaluate's; (d) `visualize` of VGG16's
     prediction.json must write 4 overlays of 300^2, and `parity_drill`
     with a module.-prefixed .pth of VGG16's weights (in a fresh
     meta_dir, so it scans the val split) must report the AP/AR of (a)'s
     evaluate of those weights.
 13. int8 serving, under build/chip_smoke_quantize/, on phase 9 (a)'s
     weights and phase 6's split: (a) the int8 conv of models/quantize.py
     (im2col + torch._int_mm) in the six geometries of
     tests/test_quantize.py at c_in = c_out = 256, and the ResNet stem at
     c_in = 3, on random int8 inputs and kernels: its int32 accumulator
     must equal a float64 conv of the same integers on the card, exactly;
     its ms per call beside the bf16 cuDNN conv's (CUDA events, in turns)
     and its bound; (b) `evaluate -p unet_weighted` with
     `quantized_serving: 1` (QUANT_CHILD, a child process, twice: the
     first run pays the process's first int8 calls): images/s and stage
     seconds of both, the calibration's seconds, the convs in the qtable
     and the _int_mm calls, AP/AR beside the float evaluate's of the same
     weights (in process), CCL launches above 0; in process the int8
     probabilities of 20 val tiles against the float ones: argmax
     agreement on confident pixels (|p - 0.5| > 0.1) above 0.98, the
     _int_mm calls per batch; (c) `export` of the int8 program (bucket
     20) in a child, then `evaluate --artifact`, whose prediction.json
     must equal (b)'s byte for byte; (d) `dense_crf` in window and grid
     mode on one 300^2 tile and its float probabilities, the card
     against the CPU within 1e-4.
 14. data parallel on the one card, under build/chip_smoke_parallel/, on
     phase 9 (a)'s weights and phase 6's files, at the defaults: (a) the
     110 val tiles at batch 20, bf16, through FusedServe on one device and
     over a mesh of two replicas on the card (cuda:0 twice), without and
     with TTA: labels and areas equal and scores within 1e-4 relative,
     except on images whose labels differ only at pixels within max
     |p_mesh - p_single| of the threshold; the mesh must launch the CCL
     `label` once per shard per batch; ms per batch of both; (b)
     `evaluate` with `data_parallel: 1` (one visible card: no mesh) must
     write the plain evaluate's prediction.json byte for byte; (c) one
     step (DDP_DEPTH's U-Net on seeded weights, dropout_2d 0.1 in the
     decoder) of the trainer in float32 (TF32
     off) and in float64 on two gloo ranks sharing the card and on one
     NCCL rank (spawned processes, parallel/distributed.py), each against
     the single-process step on the same 20 images: losses within 1e-4
     relative and running statistics within 1e-4 in both, and in float64
     every gradient within 1e-3 of its tensor's largest magnitude; the
     float32 gradients' distances (per tensor and in L2) are printed
     beside the single-process float32 step's own distance from float64,
     which is large (a rounding difference in one layer flips ReLUs
     below it), so they are not gated; (d) FIT_STEPS bf16
     UNetTrainer.fit steps from phase 6's files on two gloo ranks, rank 0
     writing last.pt, then a two-rank resume to epoch 1; ms/step of the
     ranks beside one process's on the same files.
 15. spatial serving on the one card, under build/chip_smoke_spatial/, on
     phase 9 (a)'s weights (BN folded) over meshes of 2 and 4 bands on
     cuda:0 (the card listed several times): (a) one 2048^2 tile of phase
     6's train tiles laid side by side, bf16, 300^2 out, on 2 and on 4
     bands against the unsplit forward on the card: labels and areas
     equal and scores within 1e-4 relative, except on pixels within max
     |p_spatial - p_single| (at most 1e-2) of the threshold; the
     exchange's bytes and its largest transfer (fewer rows than the
     map's), ms per tile of both (CUDA events, in turns), their peak
     device memory, one `label` launch; (b) a 512 x 256 float64 tile on 4
     bands: max |dp| <= 1e-9 against the unsplit float64 forward, labels
     and areas equal; (c) the 110 val tiles at batch 20 (256^2 in, 300^2
     out) through the pipeline's forward with FusedServe(mesh=Mesh(
     ["cuda:0"] * 2), spatial=True) against one device under (a)'s rule,
     one `label` launch a batch whose labels equal the plain CCL's on the
     batch's masks, and the CLI with spatial_serving: 1 on the one visible
     card exiting non-zero with the JAX package's message; (d) one 512^2
     tile each through VGG11, VGG16, the scratch UNet (pool 3/2) and
     UNet++ (seeded weights, float32) and the int8 forward, 4 bands,
     under (a)'s rule.
 16. JPEG, under build/chip_smoke_jpeg/, in at most 50 s: (a) every file
     of tests/fixtures/jpeg_corpus (Pillow at qualities 30-100, 4:4:4,
     4:2:2, 4:2:0, grey, optimised tables, EXIF/ICC, sizes 1x1 to 301^2,
     the port encoder's 1x2 and restart files, a truncated stream, an
     Adobe RGB file; progressive files with libjpeg's and custom scripts
     and two truncated cuts that libjpeg smooths, arithmetic-coded
     sequential and progressive files with and without DRI and DAC, a
     300^2 progressive and a 300^2 arithmetic tile, sampling 4x1, 1x4,
     4x2 and 3x1, CMYK with and without an Adobe marker, YCCK): the fused
     pixel kernel `jpeg_pixels` on the card must equal the plain version
     exactly and the decode the SHA-256 of the JAX package's in the
     manifest; the refused kinds (12-bit, lossless, hierarchical, DNL,
     2-component, more than 10 blocks an MCU) must raise naming their
     feature; then JPEG_DRAWN drawn geometries (sizes 1x1 to 3,000 wide,
     every supported sampling, ratios 1 to 4, grey, YCbCr, RGB, CMYK and
     YCCK,
     batches 1-32, random coefficients with blocks at and past the 32-bit
     IDCT's bounds and quant tables at 16 bits' extremes) must equal the
     plain version exactly, a table past 16 bits must be refused, and two
     threads decoding two geometries of very different shared memory
     through one DeviceDecoder (the daemon's handlers) must get the plain
     version's pixels on every call; (b) phase 8's 110 val tiles written as JPEG (the
     port's encoder, quality 95, 4:2:0) must decode on the card equal to
     the CPU decode (20 of them also as request bodies through the
     daemon's decoder, which leaves them on the card), and `evaluate -p
     unet_weighted` through the CLI in this process (its forward warm
     from phase 8) on phase 9 (a)'s weights must write a
     prediction.json of the 110 images with AP/AR in [0, 1], launch
     `jpeg_pixels` once a batch (6) and the CCL kernels; prints its
     images/s and decode seconds (to the kernel's end) beside phase 8's
     PNG run; (c) `jpeg_pixels` at (1, 20 and 256, 300^2, 4:2:0) as
     CUDA-graph replays (20 calls a graph), each batch first held equal
     to the plain version, in turns with the parent tree's jpeg_pixels where
     a copy lies under build/old/, the plain version, the bounds, and the host Huffman decode in ms a tile on 1
     and 8 threads;
 17. TIFF and PNG gamma, under build/chip_smoke_tiff/, in at most
     TIFF_BUDGET_S: (a) every file of tests/fixtures/tiff_corpus (Pillow's
     and the port writer's: strips and tiles, planar data, none / LZW /
     Deflate / PackBits, predictor 2, both byte orders, BigTIFF, grey,
     palette, 16-bit, alpha, fill order 2, orientation, two pages) must
     decode through `native_decode` to the SHA-256 of the JAX package's
     decode in the manifest, and the refused kinds must raise naming their
     feature; every file of tests/fixtures/png_gamma (gAMA values on both
     sides of libpng's thresholds, sRGB / cHRM / iCCP next to them, low-bit
     grey and palettes, files the JAX loader hands to Pillow) must decode
     to the JAX package's RGB and grey reads, through libpng where it
     builds and through the port's own reader, which this machine has
     (no libpng); the TIFF corpus again through
     `native_decode.assemble` on the card, its JPEG-compressed files'
     strips and tiles through `jpeg_pixels` (one launch a file and
     geometry), to the same digests; (b) TIFF_TILES synthetic 300^2 tiles
     written by the port's TIFF writer (LZW + predictor 2, one of them
     tiled) and the same pixels as PNG, then the same tiles as YCbCr 2x2
     JPEG TIFF (four in strips with a short last one, four in tiles) and
     PNG tiles of their plain-decoded pixels: `predict_on_dir -p
     unet_weighted` in this process on the card, on phase 9 (a)'s
     weights, must write the same prediction.json for each pair and
     launch the CCL kernels, and `jpeg_pixels` over the JPEG TIFFs; (c) a
     TIFF_SCENE^2 YCbCr 2x2 JPEG TIFF in TIFF_SCENE_TILE^2 tiles: its host
     entropy decode timed, `native_decode.assemble` on the card in one
     `jpeg_pixels` launch equal to the plain decode on the CPU, each
     tile's kernel pixels = the plain version on the card, and
     `jpeg_pixels` timed at the scene's batch (CUDA-graph replays) beside
     its bound;
 18. WebP, under build/chip_smoke_webp/, in at most WEBP_BUDGET_S: (a)
     every file of tests/fixtures/webp_corpus (lossy with both loop
     filters, 2 to 8 partitions and 1 to 4 segments, lossless with each
     transform and palettes, alpha raw and compressed with each filter,
     VP8X, animations, cuts) must decode through `native_decode` (its
     bitstreams in csrc/webp_decode.cpp, built with g++ at first use) to
     the SHA-256 of the JAX package's decode in the manifest, and the
     refused kinds must raise naming their cause; (b) the corpus's 8 lossy
     and 8 lossless 300^2 tiles and PNG tiles of their decoded pixels:
     `predict_on_dir -p unet_weighted` over the 16 WebP tiles in this
     process on the card, on phase 9 (a)'s weights, must write the same
     prediction.json as over the 16 PNG tiles and launch the CCL
     kernels; (c) the host decode of a 300^2 tile (lossy quality 75 and
     95, lossless) in ms on one thread.
 19. BMP and GIF, under build/chip_smoke_raster/, in at most
     RASTER_BUDGET_S: (a) every file of tests/fixtures/bmp_corpus (every
     info header size and depth, raw, RLE8, RLE4 and bitfields, top-down
     rows, grey and short palettes, headerless DIB) and of
     tests/fixtures/gif_corpus (global, local and ramp tables, offset
     frames, transparency, interlaced rows, code sizes 0 to 12) must decode
     through `native_decode` (RLE in csrc/bmp_decode.cpp, LZW in
     csrc/gif_decode.cpp, built with g++ at first use) to the SHA-256 of
     the JAX package's decode in the manifest, and the refused kinds must
     raise naming their cause; (b) the corpora's 300^2 tiles (2 raw 24-bit
     BMP, one more as a headerless DIB, 2 RLE8 BMP, 2 GIF, one of them
     interlaced) and PNG tiles of their decoded pixels (a GIF's palette
     pixels, not its source): `predict_on_dir -p unet_weighted` over the 7
     tiles in this process on the card, on phase 9 (a)'s weights, must
     write the same prediction.json as over the 7 PNG tiles and launch the
     CCL kernels; (c) the host decode of a 300^2 tile (BMP raw 24-bit, BMP
     RLE8, GIF) in ms on one thread.
 20. JPEG 2000, under build/chip_smoke_jp2/, in at most JP2_BUDGET_S: (a)
     every file of tests/fixtures/jp2_corpus (Pillow's files of every mode,
     progression and tiling; openjpeg's of every code-block style, SOP /
     EPH, POC, tile-parts, ROI, subsampling and precision; JP2 containers
     of every colour specification, palettes, PPM / PPT, cuts) must decode
     through `native_decode` (the codestream in csrc/jp2_decode.cpp, built
     in phase 2) to the SHA-256 of the JAX
     package's decode in the manifest, and the refused kinds (HTJ2K, more
     than 4 components, precision above 16 bits, ...) must raise naming
     their cause; (b) the corpus's 9 300^2 tiles (3 reversible JP2, 3
     irreversible JP2, 3 tiled RPCL J2K) and PNG tiles of their decoded
     pixels: `predict_on_dir -p unet_weighted` over the 9 tiles in this
     process on the card, on phase 9 (a)'s weights, must write the same
     prediction.json as over the 9 PNG tiles and launch the CCL kernels;
     (c) the host decode of a 300^2 tile (reversible JP2, irreversible
     JP2, tiled RPCL J2K) in ms on one thread, beside the host decode of
     the same tile as a baseline JPEG (the Huffman decode alone, and with
     the plain pixel stage on the CPU).
 21. lossless JPEG (SOF3), under build/chip_smoke_jpeg_lossless/, in at
     most JPEG_LOSSLESS_BUDGET_S: (a) the lossless files of
     tests/fixtures/jpeg_corpus (libjpeg-turbo 3.1.3's and hand-made ones:
     predictors 1-7, point transforms, restarts, scans, subsampling,
     CMYK, cuts and bad codes) and of tests/fixtures/tiff_corpus (strips
     and tiles of lossless streams, one file with lossy strips beside
     them, through `assemble` on the card) must decode through
     `native_decode` (csrc/jpeg_entropy.cpp jpeg_decode_lossless and
     jpeg_lossless_rgb, built in phase 2) to the SHA-256 of the JAX
     package's decode in the manifest, and the refused kinds (YCbCr and
     YCCK, precisions other than 8, predictor 0, ...) must raise naming
     their cause; (b) the corpus's 9 lossless 300^2 tiles and PNG tiles of
     their decoded pixels: `predict_on_dir -p unet_weighted` over the 9
     tiles in this process on the card, on phase 9 (a)'s weights, must
     write the same prediction.json as over the 9 PNG tiles, with one K1
     and one K2 launch and no `jpeg_pixels` launch; (c) the host decode
     of a 300^2 tile in ms on one thread, beside the JPEG Huffman decode
     of the same pixels as a baseline JPEG.
Kernel and cuDNN times are device times: the call is captured once in a
CUDA graph and the graph replayed between CUDA events, so the host's launch
overhead is not in them. Plain versions and torch.unique (which read
results back to the host) are timed as calls back to back between CUDA
events. Every comparison runs in turns (a, b, b, a) in this one process.

Prints one JSON line on the kernels (time, plain time, bound and what sets
it, library time), then as its last line {"ok": true, "device": {...}}.
Any failure raises: the exit code is not 0 and no result is printed.
"""

import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_BATCHES, BATCH, TILE = 3, 20, 300
DEVICE = "cuda"
SOURCES = {"ccl_label_raw": "mapping_tpu_torch/csrc/ccl.cu",
           "ccl_renumber": "mapping_tpu_torch/csrc/ccl.cu",
           "conv_dw": "mapping_tpu_torch/csrc/conv_dw.cu",
           "jpeg_pixels": "mapping_tpu_torch/csrc/jpeg_pixels.cu"}
#: the TPU kernel each replaces; the JPEG kernel replaces none (the JAX
#: package decodes on the host with libjpeg)
REPLACES = {"ccl_label_raw": "mapping_tpu/ops/ccl_pallas.py:127",
            "ccl_renumber": "mapping_tpu/ops/ccl_pallas.py:141",
            "conv_dw": "tools/dw_probe.py:70",
            "jpeg_pixels": "cpp/decode.cpp:54 (libjpeg on the host; not a "
                           "TPU kernel)"}
TRAIN_SIZE, TRAIN_STEPS = (256, 256), 5
#: NCHW shapes K3 is timed at: the JAX dW probe's two (tools/dw_probe.py)
#: and the default train step's dec0.conv and dec1.block.0.conv
DW_TIMED = {"probe C=32": (64, 32, 256, 256), "probe C=64": (64, 64, 128, 128),
            "dec0.conv": (20, 32, 256, 256),
            "dec1.block.0.conv": (20, 128, 128, 128)}
DW_MAIN = "dec0.conv"  # the shape of the kernels line
DW_TOL, DW_AUTOGRAD_TOL = 1e-4, 2e-2
#: a copy of the parent tree (git archive) to time the kernels against
OLD_TREE = ROOT / "build" / "old"
EVAL_TILES = 110  # 5 full batches of 20 and a ragged tail of 10
EVAL_DIR = ROOT / "build" / "chip_smoke_evaluate"
#: parameters of phase 8 over the JAX config's defaults (ResNet101, bf16,
#: batch 20, 300^2 -> 256^2 -> 300^2)
EVAL_PARAMS = {}
EVAL_DEPTH = 101
PREP_DIR = ROOT / "build" / "chip_smoke_prepare"
#: tiles of phase 6: train (besides a crowded and an empty tile), val, the
#: in-process sample of each mode, the tiles checked against the CPU, the
#: plain CCL and scipy
#: (1,000 train tiles until the script neared 1,000 s of its 1,200 s
#: limit with phase 17)
PREP_TRAIN, PREP_VAL, PREP_SAMPLE, PREP_CHECKED = 700, 110, 100, 20
PREP_CROWDED = 150  # buildings on the crowded tile, > MAX_OBJECTS = 128
#: the modes of phase 6 besides the JAX defaults (no erosion, dilation or
#: border), as overlay_masks arguments
PREP_MODES = {"erode3": {"erode": 3}, "erode3_dilate2": {"erode": 3,
                                                         "dilate": 2},
              "border2": {"border_width": 2}}
PREP_REL_TOL = 1e-4  # distances against scipy's, relative
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
#: parameters of phase 9 over the JAX config's defaults; leg (a) validates
#: on every val tile
TRAIN_CLI_PARAMS = {"epochs_nr": 2, "resume_every": 1, "best_write_every": 1,
                    "evaluation_data_sample": PREP_VAL}
RESUME_EPOCHS, WARM_LR = 4, 1e-4  # legs (b) and (c)
SCORING_DIR = ROOT / "build" / "chip_smoke_scoring"
#: tiles of phase 10 (a)'s scoring sample (10,000 by default), drawn from
#: phase 6's train split; cut for the script's time limit
SCORING_SAMPLE = 250
#: parameters of phase 10 over the JAX config's defaults: the scoring
#: sample, validation on every val tile
SCORING_PARAMS = {"scoring_model__num_training_examples": SCORING_SAMPLE,
                  "evaluation_data_sample": PREP_VAL}
#: phase 10 (b)'s evaluate runs: pipeline, category_layers
SCORING_EVALS = (("unet_tta", [1, 1]), ("unet_padded", [1, 1]),
                 ("unet_scoring_model", [1, 19]),
                 ("unet_padded_scoring_model", [1, 19]),
                 ("unet_tta_scoring_model", [1, 19]))
SERVE_DIR = ROOT / "build" / "chip_smoke_serving"
#: phase 11's batch buckets besides batch_size_inference (20), and the
#: client concurrencies its serve children are driven at
SERVE_BUCKETS, SERVE_CONCURRENCY = "1,4", (1, 16)
SERVE_DEADLINE = 300  # seconds a serve child gets to answer /v1/health
#: parameters of phase 11 over the JAX config's defaults (ResNet101, bf16,
#: batch 20, 300^2 -> 256^2 -> 300^2)
SERVE_PARAMS = {}
ZOO_DIR = ROOT / "build" / "chip_smoke_zoo"
#: phase 12's families (the config's `encoder`), the tiles of its train
#: sub-split (phase 6's train split holds 702), and the train steps of its
#: multi-head leg
ZOO_FAMILIES = ("VGG11", "VGG16", "from_scratch", "UNetPlusPlus")
ZOO_TRAIN, ZOO_MULTI_STEPS = 200, 3
#: parameters of phase 12 over the JAX config's defaults (bf16, batch 20,
#: 256^2 in, 300^2 out): one epoch, validated on every val tile
ZOO_PARAMS = {"epochs_nr": 1, "evaluation_data_sample": PREP_VAL}
#: the CCL kernels of the fused `label` (csrc/ccl.cu), by name part
QUANT_DIR = ROOT / "build" / "chip_smoke_quantize"
#: phase 13's settings over the JAX config's defaults: int8 serving
#: calibrated on the first 32 metadata images (the JAX default)
QUANT_PARAMS = {"quantized_serving": 1, "quant_calib_images": 32}
QUANT_WIDTH = 256  # c_in = c_out of phase 13 (a)'s conv geometries
#: model parameters of phase 13 over the JAX config's defaults (ResNet101,
#: bf16, batch 20, 256^2 in, 300^2 out)
QUANT_MODEL = {}
QUANT_AGREEMENT = 0.98  # tests/test_quantize.py's confident-pixel gate
CRF_TOL = 1e-4  # dense_crf on the card against the CPU, absolute
PARALLEL_DIR = ROOT / "build" / "chip_smoke_parallel"
#: phase 14 (c): loss relative, each float64 gradient tensor against its
#: largest magnitude, BatchNorm running statistics against their largest
DDP_LOSS_TOL, DDP_GRAD_TOL, DDP_STAT_TOL = 1e-4, 1e-3, 1e-4
#: phase 14 (c), (d): a bf16 loss relative to one process's bf16 loss
#: (bf16's unit roundoff, 2^-8); the ranks' bf16 gradients from one
#: process's bf16 ones (relative L2 over all tensors) at most this times
#: one process's bf16 distance from its float64 step
BF16_LOSS_TOL, BF16_L2_MARGIN = 2.0 ** -8, 2.0
#: phase 14 (a): the mesh (shards of BATCH / 2) against one device at the
#: shard's batch: max |dp| of the served probabilities (the band of
#: tests/test_torch_evaluate.py's assert_same_instances); against one
#: device at BATCH: max |dp| at most BAND_MARGIN times one device's own
#: batch-BATCH/2-against-BATCH reading, and at most BAND_CEIL
SHARD_BAND, BAND_MARGIN, BAND_CEIL = 1e-4, 2.0, 1e-2
#: phase 14 (c), (d): the depth of the steps' and fits' U-Net, on seeded
#: weights; cut from the defaults' ResNet101 (and (d)'s steps from 3 an
#: epoch to 1) for the script's time, of which the ranks' start-up, model
#: builds and checkpoints of ResNet101 took 132 s on an H100 host; (a)
#: and (b) serve phase 9's ResNet101
DDP_DEPTH = 34
#: phase 14 (c)'s model over the defaults: the decoder's spatial dropout on
#: (the ResNet U-Nets ignore dropout_conv, in the JAX package too)
DDP_MODEL = {"encoder": f"ResNet{DDP_DEPTH}", "dropout_2d": 0.1}
FIT_STEPS = 1  # phase 14 (d): optimizer steps per epoch
#: phase 14's parameters over the JAX config's defaults (ResNet101, bf16,
#: batch 20, 256^2 in, 300^2 out), and (d)'s model_params over them
PARALLEL_PARAMS, FIT_MODEL = {}, {"encoder": f"ResNet{DDP_DEPTH}"}
SPATIAL_DIR = ROOT / "build" / "chip_smoke_spatial"
#: phase 15: the side of (a)'s tile, its band counts, (b)'s float64 tile
#: (H, W) and its gate on max |dp|, (d)'s tile side and band count
SPATIAL_SIDE, SPATIAL_BANDS = 2048, (2, 4)
SPATIAL_F64, SPATIAL_F64_TOL = (512, 256), 1e-9
SPATIAL_FAMILY_SIDE, SPATIAL_FAMILY_BANDS = 512, 4
#: (d)'s families: encoder and model_params over the JAX config's
#: defaults; float32, because their seeded weights, rescaled to spread the
#: probabilities, amplify bf16's rounding (in bf16 the scratch UNet's
#: bands moved probabilities by 0.09 on an H100)
SPATIAL_FAMILIES = (("VGG11", {}), ("VGG16", {}),
                    ("from_scratch", {"pool_kernel": 3, "pool_stride": 2}),
                    ("UNetPlusPlus", {}))
#: (a)'s instance pad: wide enough for the tile's buildings, so that no
#: overflow rerun enters its times
SPATIAL_PAD = 1024
CCL_KERNELS = ("tile_label", "merge_borders", "resolve", "scan", "gather")
JPEG_KERNELS = ("jpeg_pixels",)
JPEG_DIR = ROOT / "build" / "chip_smoke_jpeg"
JPEG_CORPUS = ROOT / "tests" / "fixtures" / "jpeg_corpus"
#: phase 16 (a): drawn geometries held against the plain version, and the
#: pixels of a case's batch, at most
JPEG_DRAWN, JPEG_DRAWN_PIXELS = 200, 1 << 20
#: phase 16 (a): decodes a thread, two threads at once
JPEG_THREAD_CALLS = 200
#: phase 16 (c): the batches timed, CUDA-graph replays of the kernels,
#: calls of the plain version (fewer at the largest batch), tiles of the
#: host Huffman decode's timing; the phase's budget
JPEG_BATCHES = (1, BATCH, 256)
JPEG_REPS, JPEG_PLAIN_REPS, JPEG_ENTROPY_TILES = 50, 20, 200
#: calls captured in one CUDA graph: at batch 1 a call is shorter than the
#: host takes to replay a graph
JPEG_GRAPH_CALLS = 20
JPEG_BUDGET_S = 40.0
TIFF_DIR = ROOT / "build" / "chip_smoke_tiff"
TIFF_CORPUS = ROOT / "tests" / "fixtures" / "tiff_corpus"
PNG_GAMMA = ROOT / "tests" / "fixtures" / "png_gamma"
#: phase 17 (b): the tiles written as TIFF and as PNG; (c) the JPEG-TIFF
#: scene's side and tile side; the phase's budget
TIFF_TILES = 8
TIFF_SCENE, TIFF_SCENE_TILE = 4096, 256
TIFF_BUDGET_S = 30.0
WEBP_DIR = ROOT / "build" / "chip_smoke_webp"
WEBP_CORPUS = ROOT / "tests" / "fixtures" / "webp_corpus"
#: phase 18 (c): the 300^2 tiles timed and the decodes of each; the
#: phase's budget
WEBP_TIMED = {"lossy q75": "lossy_q75_300.webp",
              "lossy q95": "lossy_q95_300.webp",
              "lossless": "lossless_300.webp"}
WEBP_REPS = 50
WEBP_BUDGET_S = 20.0
RASTER_DIR = ROOT / "build" / "chip_smoke_raster"
BMP_CORPUS = ROOT / "tests" / "fixtures" / "bmp_corpus"
GIF_CORPUS = ROOT / "tests" / "fixtures" / "gif_corpus"
#: phase 19 (c): the 300^2 tiles timed and the decodes of each; the
#: phase's budget
RASTER_TIMED = {"BMP raw 24-bit": BMP_CORPUS / "tile300_raw24_0.bmp",
                "BMP RLE8": BMP_CORPUS / "tile300_rle8_0.bmp",
                "GIF": GIF_CORPUS / "tile300_0.gif"}
RASTER_REPS = 50
RASTER_BUDGET_S = 20.0
JP2_DIR = ROOT / "build" / "chip_smoke_jp2"
JP2_CORPUS = ROOT / "tests" / "fixtures" / "jp2_corpus"
#: phase 20 (c): the 300^2 tiles timed and the decodes of each; the
#: phase's budget
JP2_TIMED = {"reversible JP2": "tile300_reversible_0.jp2",
             "irreversible JP2": "tile300_irreversible_0.jp2",
             "tiled RPCL J2K": "tile300_rpcl_0.j2k"}
JP2_REPS = 20
JP2_BUDGET_S = 20.0
JPEG_LOSSLESS_DIR = ROOT / "build" / "chip_smoke_jpeg_lossless"
#: phase 21 (c): decodes of a 300^2 tile a median; the phase's budget
JPEG_LOSSLESS_REPS = 20
JPEG_LOSSLESS_BUDGET_S = 20.0
#: a child process that runs the CLI's entry point on its arguments and
#: prints the CCL launch counts of its run as its last line
CLI_CHILD = ("import json, sys\n"
             "from mapping_tpu_torch import main\n"
             "from mapping_tpu_torch.kernels import ccl\n"
             "main.main(sys.argv[1:])\n"
             "print('ccl launches ' + json.dumps(ccl.LAUNCHES))\n")
#: the same for several commands, each argument one argv as JSON
CLI_CHILDREN = ("import json, sys\n"
                "from mapping_tpu_torch import main\n"
                "from mapping_tpu_torch.kernels import ccl\n"
                "for argv in sys.argv[1:]:\n"
                "    main.main(json.loads(argv))\n"
                "print('ccl launches ' + json.dumps(ccl.LAUNCHES))\n")
#: the CLI's `serve` in a child process: SIGTERM ends it (the daemon
#: closes its batcher), then it prints its CCL launch counts
SERVE_CHILD = ("import json, signal, sys\n"
               "from mapping_tpu_torch import main\n"
               "from mapping_tpu_torch.kernels import ccl, jpeg\n"
               "signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))\n"
               "try:\n"
               "    main.main(sys.argv[1:])\n"
               "finally:\n"
               "    print('ccl launches ' + json.dumps({**ccl.LAUNCHES, "
               "**jpeg.LAUNCHES}), flush=True)\n")


#: phase 13 (b): the CLI in a child process, twice (the first run pays
#: the process's first int8 calls); prints both runs' stage seconds, the
#: second run's int8 matrix products and CCL launch counts as one line
QUANT_CHILD = ("import json, sys\n"
               "from mapping_tpu_torch import main\n"
               "from mapping_tpu_torch.kernels import ccl\n"
               "from mapping_tpu_torch.models import quantize\n"
               "cold = main.main(sys.argv[1:]).timings\n"
               "quantize.MATMULS['int_mm'] = 0\n"
               "ccl.reset_launches()\n"
               "manager = main.main(sys.argv[1:])\n"
               "print('quantized ' + json.dumps({'cold': cold, 'timings': "
               "manager.timings, 'int_mm': quantize.MATMULS['int_mm'], "
               "'launches': dict(ccl.LAUNCHES)}))\n")
#: phase 12's families in turn in one child process: for each config, the
#: CLI's `train -p unet_weighted`, then its `evaluate` of that experiment;
#: prints the device memory still allocated at the family's start (after
#: the previous family's objects are collected), the CCL launch counts,
#: the peak device memory of each command and the evaluate's stage
#: seconds as one JSON line a family
ZOO_CHILD = ("import gc, json, sys, time, torch\n"
             "from mapping_tpu_torch import main\n"
             "from mapping_tpu_torch.kernels import ccl\n"
             "for config in sys.argv[1:]:\n"
             "    gc.collect()\n"
             "    torch.cuda.empty_cache()\n"
             "    start = time.perf_counter()\n"
             "    out = {'start_mib': "
             "torch.cuda.memory_allocated() / 2 ** 20}\n"
             "    ccl.reset_launches()\n"
             "    torch.cuda.reset_peak_memory_stats()\n"
             "    main.main(['--config', config, 'train', '-p', "
             "'unet_weighted'])\n"
             "    out['train_peak_mib'] = torch.cuda.max_memory_allocated() "
             "/ 2 ** 20\n"
             "    out['train_launches'] = dict(ccl.LAUNCHES)\n"
             "    torch.cuda.reset_peak_memory_stats()\n"
             "    manager = main.main(['--config', config, 'evaluate', '-p', "
             "'unet_weighted'])\n"
             "    out['evaluate_peak_mib'] = "
             "torch.cuda.max_memory_allocated() / 2 ** 20\n"
             "    out['timings'] = manager.timings\n"
             "    out['launches'] = dict(ccl.LAUNCHES)\n"
             "    out['seconds'] = time.perf_counter() - start\n"
             "    del manager\n"
             "    print('zoo ' + json.dumps(out), flush=True)\n")


def card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA card")
    if not (ROOT / "mapping_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: no mapping_tpu_torch package beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def ccl_cases(gen):
    """name -> (N, H, W) bool mask on the card."""
    from mapping_tpu_torch.kernels.ccl import TILE_H, TILE_W

    def noise(n, h, w, density):
        return torch.rand((n, h, w), generator=gen) < density

    rects = torch.zeros((2, 48, 48), dtype=torch.bool)
    for b in range(2):
        for _ in range(6):
            y, x = torch.randint(0, 38, (2,), generator=gen).tolist()
            h, w = torch.randint(3, 12, (2,), generator=gen).tolist()
            rects[b, y:y + h, x:x + w] = True
    spiral = torch.zeros((1, 32, 32), dtype=torch.bool)
    spiral[0, 2, 2:30] = True
    spiral[0, 2:30, 29] = True
    spiral[0, 29, 4:30] = True
    spiral[0, 6:30, 4] = True
    spiral[0, 6, 4:26] = True
    dots = torch.zeros((2, TILE, TILE), dtype=torch.bool)
    dots[:, ::2, ::2] = True  # 22,500 single-pixel components per image
    snake = torch.zeros((1, TILE, TILE), dtype=torch.bool)
    snake[0, ::2] = True  # one 45,150-pixel path: rows joined at alternate ends
    snake[0, 1::4, -1] = True
    snake[0, 3::4, 0] = True
    th, tw = TILE_H, TILE_W  # K1's tiles: lines on every border
    grid = torch.zeros((3, TILE, TILE), dtype=torch.bool)
    grid[0, ::th] = True  # the tiles' first row and column
    grid[0, :, ::tw] = True
    grid[1, th - 1::th] = True  # their last row and column
    grid[1, :, tw - 1::tw] = True
    grid[2] = grid[0] | grid[1]  # both sides of every border
    corners = torch.zeros((3, TILE, TILE), dtype=torch.bool)
    for y0 in range(th, TILE, th):  # one component on each corner
        for x0 in range(tw, TILE, tw):
            corners[0, y0 - 1:y0 + 1, x0 - 1:x0 + 1] = True  # a 2x2 square
            corners[1, y0 - 3:y0 + 3, x0 - 3:x0 + 3] = True  # a ring
            corners[1, y0 - 2:y0 + 2, x0 - 2:x0 + 2] = False
            for i in range(4):  # a staircase across the corner
                corners[2, y0 - 2 + i, x0 - 2 + i:x0 + i] = True
    row = noise(1, 3, 70000, 0.6)  # a row 1,094 tiles wide
    row[0, 1] = True  # one component through all of them
    cases = {
        "rects": rects, "noise48": noise(1, 48, 48, 0.45), "spiral": spiral,
        "empty16": torch.zeros((1, 16, 16), dtype=torch.bool),
        "full16": torch.ones((1, 16, 16), dtype=torch.bool),
        **{f"batch20_d{d}": noise(BATCH, TILE, TILE, d)
           for d in (0.3, 0.5, 0.7)},
        "noise304": noise(2, 304, 304, 0.5),
        "nonsquare": noise(3, 40, 57, 0.55),
        "wide": noise(2, 120, 333, 0.6),
        "empty20": torch.zeros((BATCH, TILE, TILE), dtype=torch.bool),
        "full20": torch.ones((BATCH, TILE, TILE), dtype=torch.bool),
        "dots": dots, "snake": snake, "tile_grid": grid,
        "tile_corners": corners, "row70000": row,
    }
    return {k: v.to(DEVICE) for k, v in cases.items()}


def cuda_ms(fn, reps):
    """ms per call of `reps` calls back to back between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, calls=1):
    """Device ms per call: `calls` calls of `fn` captured in one CUDA
    graph (after one call outside it), the graph replayed `reps` times
    between events. Several calls a graph keep a short kernel's time
    above the host's rate of replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


def in_turns(fns, timer, reps):
    """{name: (first, second)}: the timings in the order a, b, ..., b, a."""
    order = list(fns) + list(fns)[::-1]
    got = {name: [] for name in fns}
    for name in order:
        got[name].append(timer[name](fns[name], reps[name]))
    return {name: tuple(v) for name, v in got.items()}


def old_kernels():
    """Callables of the parent tree's K1, K2, K3 and JPEG pixel stage
    (`jpeg_pixels`) from the copy under OLD_TREE, built in build_phase, or
    {} when there is no copy."""
    import ctypes
    import importlib.util

    from mapping_tpu_torch.kernels import build

    if not (OLD_TREE / "mapping_tpu_torch" / "csrc").is_dir():
        return {}
    csrc = OLD_TREE / "mapping_tpu_torch" / "csrc"
    libs = build.build_shared_libraries(
        {"old_ccl": [csrc / "ccl.cu"], "old_conv_dw": [csrc / "conv_dw.cu"],
         "old_jpeg": [csrc / "jpeg_pixels.cu"]})
    ccl = ctypes.CDLL(str(libs["old_ccl"].path))
    for fn in (ccl.ccl_label_raw, ccl.ccl_renumber):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    dw = ctypes.CDLL(str(libs["old_conv_dw"].path))
    dw.conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    spec = importlib.util.spec_from_file_location(
        "old_conv_dw", OLD_TREE / "mapping_tpu_torch" / "kernels" /
        "conv_dw.py")
    old_plan = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_plan)
    jp = ctypes.CDLL(str(libs["old_jpeg"].path))
    jp.jpeg_pixels.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    jp.jpeg_pixels.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "old_jpeg", OLD_TREE / "mapping_tpu_torch" / "kernels" / "jpeg.py")
    old_jpeg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_jpeg)

    def ccl_call(fn, src):
        """The parent's ccl entry point on src, with scratch of src's
        size in int32 (more than either needs)."""
        n, h, w = src.shape
        scratch = torch.empty(src.shape, dtype=torch.int32, device=src.device)
        out = torch.empty_like(scratch)
        err = fn(src.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, h, w,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {fn.__name__}: error {err}")
        return out

    def conv_dw(x, dy, k):
        n, c, h, w = x.shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        pl = old_plan.plan(n, h, w, c, k, sms)
        partial = torch.empty((pl.slices, k * k * c * c), dtype=torch.float32,
                              device=x.device)
        out = torch.empty((c, c, k, k), dtype=torch.float32, device=x.device)
        fields = (ctypes.c_int * old_plan._PLAN_FIELDS)(
            *pl[:old_plan._PLAN_FIELDS])
        err = dw.conv_dw_bf16(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), fields,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old conv_dw: error {err}")
        return out

    def jpeg_pixels(coef, quant, g):
        """The parent's fused `jpeg_pixels` (one launch), with the
        parent's geometry record."""
        b = coef.shape[0]
        out = torch.empty((b, g.height, g.width, 3), dtype=torch.uint8,
                          device=coef.device)
        rec = old_jpeg.geometry_record(g)
        err = jp.jpeg_pixels(coef.data_ptr(), quant.data_ptr(),
                             out.data_ptr(), b, ctypes.addressof(rec),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old jpeg_pixels: error {err}")
        return out

    return {"ccl_label_raw": lambda m: ccl_call(ccl.ccl_label_raw, m),
            "ccl_renumber": lambda raw: ccl_call(ccl.ccl_renumber, raw),
            "conv_dw": conv_dw, "jpeg_pixels": jpeg_pixels}


def ccl_times(masks, what, old, plain=True):
    """K1 and the fused mask -> consecutive labels on `masks`, kernels as
    CUDA-graph replays, in turns with the parent tree's K1 and K1 + K2
    (where `old` has them) and the plain versions (`plain`). Returns
    {run: {version: (first, second)}}; the masks are saved under
    build/ccl_masks/ for tools/kernel_variants.py."""
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber

    h, w = masks.shape[-2:]
    runs = {
        "ccl_label_raw": {"kernel": lambda: K.label_raw(masks)},
        "label (fused)": {"kernel": lambda: K.label(masks),
                          "K1 + K2": lambda: K.renumber(K.label_raw(masks))},
    }
    if old:
        runs["ccl_label_raw"]["parent kernel"] = lambda: old[
            "ccl_label_raw"](masks)
        runs["label (fused)"]["parent K1 + K2"] = lambda: old["ccl_renumber"](
            old["ccl_label_raw"](masks))
    if plain:
        runs["ccl_label_raw"]["plain"] = lambda: _label_raw(masks, h + w)
        runs["label (fused)"]["plain"] = lambda: _renumber(
            _label_raw(masks, h + w))
    timer = {"plain": cuda_ms}
    reps = {"plain": 5}
    got = {}
    for run, fns in runs.items():
        got[run] = in_turns(fns, {k: timer.get(k, graph_ms) for k in fns},
                            {k: reps.get(k, 100) for k in fns})
        print(f"time {run} {tuple(masks.shape)} {what}: " + ", ".join(
            f"{v} {a:.4f} / {b:.4f} ms" for v, (a, b) in got[run].items())
            + ("" if old else "; no parent tree under build/old"))
    out = ROOT / "build" / "ccl_masks"
    out.mkdir(parents=True, exist_ok=True)
    torch.save(masks.cpu(), out / f"{what.replace(' ', '_')}.pt")
    return got


def kernel_phase(gen):
    from scipy import ndimage

    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import (_label_raw, _renumber,
                                           connected_components)
    from mapping_tpu_torch.tools.kernel_variants import (kernel_events,
                                                          short_name)

    lib = K.library()[0]
    print(f"K1 tile_label: {lib.ccl_tile_blocks_per_sm()} blocks of 256 "
          f"threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    err = {"ccl_label_raw": 0, "ccl_renumber": 0}
    for name, m in ccl_cases(gen).items():
        h, w = m.shape[-2:]
        raw_k = K.label_raw(m)
        ren_k = K.renumber(raw_k)
        lab_k = K.label(m)
        raw_p = _label_raw(m, h + w)
        ren_p = _renumber(raw_p)
        ren_from_plain = K.renumber(raw_p)
        torch.cuda.synchronize()
        e_raw = int((raw_k.long() - raw_p.long()).abs().max())
        e_ren = max(int((ren_k.long() - ren_p.long()).abs().max()),
                    int((ren_from_plain.long() - ren_p.long()).abs().max()))
        e_lab = int((lab_k.long() - ren_p.long()).abs().max())
        lab_np, m_np = lab_k.cpu().numpy(), m.cpu().numpy()
        n_comp = [ndimage.label(m_np[b])[1] for b in range(m_np.shape[0])]
        scipy_ok = all(np.array_equal(lab_np[b], ndimage.label(m_np[b])[0])
                       for b in range(m_np.shape[0]))
        print(f"kernel case {name} {tuple(m.shape)}: components max "
              f"{max(n_comp)}, |raw kernel - plain| {e_raw}, "
              f"|renumber kernel - plain| {e_ren}, |fused label - plain| "
              f"{e_lab}, fused label = scipy {scipy_ok} (tolerance: exact)")
        if e_raw or e_ren or e_lab or not scipy_ok:
            raise AssertionError(f"CCL kernel disagrees on case {name}")
        err["ccl_label_raw"] = max(err["ccl_label_raw"], e_raw, e_lab)
        err["ccl_renumber"] = max(err["ccl_renumber"], e_ren, e_lab)

    # kernels per connected_components call, as the profiler sees them
    m = (torch.rand((BATCH, TILE, TILE), generator=gen) < 0.5).to(DEVICE)
    old = old_kernels()
    counts = {"connected_components": kernel_events(
        lambda: connected_components(m))}
    if old:
        counts["parent K1 + K2"] = kernel_events(
            lambda: old["ccl_renumber"](old["ccl_label_raw"](m)))
    for what, events in counts.items():
        print(f"kernels per call, {what} (20, 300, 300) density 0.5: "
              f"{len(events)}, device µs under the profiler: " + ", ".join(
                  f"{short_name(k)} {us:.1f}" for k, us in events))
    if len(counts["connected_components"]) != 5:
        raise AssertionError("connected_components should launch 5 kernels")

    # times at the serving shape, in turns
    raw = K.label_raw(m)
    offset = (torch.arange(BATCH, device=DEVICE, dtype=torch.int32)
              * (TILE * TILE + 1)).view(-1, 1, 1)
    shifted = raw + offset  # labels of all images in one numbering
    if old and not (torch.equal(old["ccl_label_raw"](m), K.label_raw(m))
                    and torch.equal(old["ccl_renumber"](raw),
                                    K.renumber(raw))):
        raise AssertionError("the parent tree's CCL kernels disagree")
    k1 = ccl_times(m, "density 0.5", old)["ccl_label_raw"]
    fns = {"plain": lambda: _renumber(raw),
           "torch.unique": lambda: torch.unique(shifted, sorted=True,
                                                return_inverse=True),
           "kernel": lambda: K.renumber(raw),
           **({"parent kernel": lambda: old["ccl_renumber"](raw)} if old
              else {})}
    timer = {"plain": cuda_ms, "torch.unique": cuda_ms, "kernel": graph_ms,
             "parent kernel": graph_ms}
    reps = {"plain": 5, "torch.unique": 20, "kernel": 100, "parent kernel": 100}
    got = in_turns(fns, timer, reps)
    print(f"time ccl_renumber (20, 300, 300) density 0.5: " + ", ".join(
        f"{what} {a:.4f} / {b:.4f} ms" for what, (a, b) in got.items())
        + ("" if old else "; no parent tree under build/old"))
    times = {"ccl_label_raw": (sum(k1["kernel"]) / 2, sum(k1["plain"]) / 2,
                               None),
             "ccl_renumber": (sum(got["kernel"]) / 2, sum(got["plain"]) / 2,
                              sum(got["torch.unique"]) / 2)}
    return err, times

def random_model(depth, gen):
    """UNetResNet weights from `gen`: He-normal convs (the last conv of
    each residual branch scaled by 0.2, so that the residual stream does
    not double per block), small biases, BN affine parameters and running
    statistics randomised. Each transposed conv is a random channel mix
    times the bilinear 4x4 kernel: random 4x4 taps would print a
    checkerboard on the output, and thresholding that gives thousands of
    one-pixel instances per tile instead of blobs."""
    from mapping_tpu_torch.models.unet_resnet import UNetResNet

    model = UNetResNet(depth)
    tap = torch.tensor([1.0, 3.0, 3.0, 1.0]) / 4
    with torch.no_grad():
        for name, p in model.named_parameters():
            mod = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(mod, torch.nn.ConvTranspose2d) and p.dim() == 4:
                mix = torch.randn(p.shape[:2], generator=gen)
                p.copy_(mix[..., None, None] * torch.outer(tap, tap)
                        * math.sqrt(2.0 / p.shape[0]))
            elif p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                gain = 0.2 if name.endswith("conv3.weight") else 1.0
                p.copy_(torch.randn(p.shape, generator=gen)
                        * gain * math.sqrt(2.0 / fan_in))
            elif ".bn" in name or ".downsample.1." in name:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.01 * torch.randn(p.shape, generator=gen))
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=gen))
    return model


def centre_logits(model, images):
    """Rescale the final conv (the model's last) so that the class logit
    difference over `images` has mean 0 and standard deviation 4: about
    half the pixels are foreground and probabilities do not saturate."""
    model = model.to(DEVICE).eval()
    final = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)][-1]
    with torch.no_grad():
        logits = model(images.permute(0, 3, 1, 2))
        diff = logits[:, 1] - logits[:, 0]
        centre, scale = diff.mean(), 4.0 / diff.std()
        w, b = final.weight, final.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - centre)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def make_tiles(gen, n):
    """n blobby uint8 (TILE, TILE, 3) tiles: upsampled low-res noise."""
    low = torch.rand((n, 3, 19, 19), generator=gen)
    return (torch.nn.functional.interpolate(
        low, size=(TILE, TILE), mode="bilinear", align_corners=False)
        * 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()


def pipeline(params, state=None, device=None):
    """The port's unet_weighted inference pipeline for the JAX parameter
    dict `params` (defaults from the JAX config), serving `state`."""
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.pipelines import PIPELINES

    config = build_config(overrides={**params, "device": device or DEVICE})
    pipe = PIPELINES["unet_weighted"]["inference"](config)
    return pipe if state is None else pipe.set_weights(state)


def probs_of(pipe, tiles_u8):
    """Softmax probabilities of the pipeline's forward on uint8 tiles."""
    return pipe.trainer.probs_apply_fn()(pipe.loader.infer_preprocess(tiles_u8))


def serving_pipeline(gen, probe_tiles):
    """The slice's pipeline: ResNet101, 32 filters, deconv, bf16, batch
    BATCH, random weights from `gen` with logits centred on `probe_tiles`.
    Returns (pipeline, params, state)."""
    from mapping_tpu_torch.data.loader import infer_batch_resize

    params = {"encoder": "ResNet101", "model_dtype": "bfloat16",
              "batch_size_inference": BATCH}
    probe = infer_batch_resize(torch.from_numpy(probe_tiles).to(DEVICE),
                               (256, 256))
    state = centre_logits(random_model(101, gen), probe)
    return pipeline(params, state), params, state


def slice_phase(gen, smi):
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.infer.postprocess import fused_postprocess
    from mapping_tpu_torch.infer.serving import FusedServe
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.ops.instance import instance_areas_and_prob_sums

    tiles = make_tiles(gen, N_BATCHES * BATCH)
    pipe, params, state = serving_pipeline(gen, tiles[:BATCH])

    list(pipe.transform_arrays(tiles[:BATCH]))  # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    K.reset_launches()
    start = time.perf_counter()
    rows = list(pipe.transform_arrays(tiles))
    seconds = time.perf_counter() - start
    launches = dict(K.LAUNCHES)
    print(f"slice: ResNet101 bf16, {N_BATCHES} batches of {BATCH} tiles "
          f"{TILE}^2 in {seconds:.4f} s: {seconds / N_BATCHES:.4f} s/batch, "
          f"{len(rows) / seconds:.2f} images/s on {smi}")
    print(f"slice: CCL launches in that run {launches}")
    if len(rows) != N_BATCHES * BATCH:
        raise AssertionError(f"transform yielded {len(rows)} images")
    if min(launches.values()) < 1:
        raise AssertionError("the slice did not go through the CCL kernels")
    n_inst = [len(trimmed[1]) for _, trimmed in rows]
    for lab, trimmed in rows:
        if lab.shape != (2, TILE, TILE) or lab[0].any():
            raise AssertionError(f"bad labels {lab.shape}")
        if not np.isfinite(trimmed[1]).all() or min(trimmed[1], default=1) <= 0:
            raise AssertionError("scores must be finite and positive")
    print(f"slice: instances per image min {min(n_inst)} max {max(n_inst)}")
    if max(n_inst) == 0:
        raise AssertionError("no instances at all")

    # kernel path vs plain path on the same probabilities
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=(1,))
    probs = probs_of(pipe, tiles[:BATCH])
    labels, scores, areas = fused_postprocess(probs, **post)
    layer = resize_bilinear(probs, (TILE, TILE))[..., 1]
    plain = _renumber(_label_raw(layer > 0.5, 2 * TILE))
    p_areas, p_sums = instance_areas_and_prob_sums(plain, layer, 256)
    p_areas, p_sums = p_areas[:, 1:], p_sums[:, 1:]
    p_scores = torch.where(
        p_areas > 0,
        p_sums / p_areas.clamp(min=1).float() * p_areas.float().sqrt(), 0.0)
    if not (torch.equal(labels[:, 1], plain)
            and torch.equal(areas[:, 1], p_areas)
            and torch.allclose(scores[:, 1], p_scores, rtol=1e-6, atol=0)):
        raise AssertionError("kernel path differs from the plain path")
    print(f"slice: kernel path = plain path on batch 0 "
          f"({int(plain.amax())} instances max)")
    ccl_times(layer > 0.5, "serving masks", old_kernels(), plain=False)

    # float32 on the card vs float32 on the CPU, 2 images
    params32 = {**params, "model_dtype": "float32"}
    p_card = probs_of(pipeline(params32, state), tiles[:2]).cpu()
    p_cpu = probs_of(pipeline(params32, state, device="cpu"), tiles[:2])
    p_bf16 = probs[:2].cpu()
    err32 = float((p_card - p_cpu).abs().max())
    print(f"slice: float32 probabilities card vs CPU max |diff| {err32:.3e}; "
          f"bf16 vs float32 CPU max |diff| "
          f"{float((p_bf16 - p_cpu).abs().max()):.3e}")
    if not err32 < 1e-3:
        raise AssertionError("float32 forward on the card disagrees with CPU")

    # overflow escalation through FusedServe.collect
    p1 = torch.zeros((2, TILE, TILE))
    p1[0, ::6, ::6] = 1.0  # 2,500 components: pad 256 -> 4096
    p1[1, ::3, ::3] = 1.0  # 10,000 components: past the 4096 ceiling
    dense = torch.stack([1 - p1, p1], dim=-1).to(DEVICE)
    serve = FusedServe(lambda x: x, **post)
    labels_o, scores_o, areas_o = serve(dense)
    counts = labels_o[:, 1].max(axis=(1, 2))
    print(f"overflow: components {counts.tolist()}, instance pad "
          f"{scores_o.shape[-1]}, first image's instances all scored "
          f"{bool((areas_o[0, 1, :2500] == 1).all())}")
    if scores_o.shape[-1] != 4096 or counts.tolist() != [2500, 10000] \
            or not (areas_o[0, 1, :2500] == 1).all() \
            or (areas_o[0, 1, 2500:] != 0).any():
        raise AssertionError("overflow escalation did not run as expected")
    return launches


def build_phase():
    from mapping_tpu_torch.kernels import build, ccl, conv_dw, jpeg
    from mapping_tpu_torch.utils import jp2
    from mapping_tpu_torch.utils import jpeg as jpeg_host

    specs = {k.LIBRARY: k.SOURCES for k in (ccl, conv_dw, jpeg)}
    if (OLD_TREE / "mapping_tpu_torch" / "csrc").is_dir():
        csrc = OLD_TREE / "mapping_tpu_torch" / "csrc"
        specs.update(old_ccl=[csrc / "ccl.cu"],
                     old_conv_dw=[csrc / "conv_dw.cu"],
                     old_jpeg=[csrc / "jpeg_pixels.cu"])
    start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # csrc/jp2_decode.cpp, the longest g++ build, beside nvcc; raises
        # naming it
        host = pool.submit(jp2.load)
        for name, built in build.build_shared_libraries(specs).items():
            print(f"build: {built.path.name} in {built.seconds:.2f} s")
            for line in built.log.splitlines():
                print(f"build: {line}")
                spill = re.search(r"(\d+) bytes spill stores", line)
                if spill and int(spill.group(1)) and \
                        not name.startswith("old"):
                    raise AssertionError(f"{name}: ptxas reports a spill: "
                                         f"{line}")
        host.result()
    print(f"build: csrc/jp2_decode.cpp (g++ {' '.join(jp2.FLAGS)}) loaded "
          f"{time.perf_counter() - start:.2f} s after the builds began")
    start = time.perf_counter()
    jpeg_host.load()  # csrc/jpeg_entropy.cpp with g++; raises naming it
    print(f"build: csrc/jpeg_entropy.cpp (g++) loaded in "
          f"{time.perf_counter() - start:.2f} s")


def conv_dw_phase():
    from mapping_tpu_torch.kernels import conv_dw as K
    from mapping_tpu_torch.ops.conv_dw import conv_dw_plain
    from mapping_tpu_torch.tools.dw_probe import dw_cudnn

    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def randn(shape, channels_last=True):
        t = torch.randn(shape, generator=gen, device=DEVICE,
                        dtype=torch.bfloat16)
        return t.contiguous(memory_format=torch.channels_last) \
            if channels_last else t

    cases = {  # name -> (x shape, k)
        "k3_c32": ((8, 32, 64, 64), 3), "k3_c64": ((8, 64, 64, 64), 3),
        "k3_c128": ((4, 128, 32, 32), 3), "k5_c32": ((4, 32, 40, 40), 5),
        "batch1": ((1, 32, 256, 256), 3), "h_ne_w_nchw": ((3, 32, 37, 300), 3),
        "zero_dy": ((2, 32, 64, 64), 3)}
    max_err = 0.0
    for name, (shape, k) in cases.items():
        x = randn(shape, channels_last=name != "h_ne_w_nchw")
        dy = torch.zeros_like(x) if name == "zero_dy" else randn(
            shape, channels_last=name != "h_ne_w_nchw")
        got, again = K.conv_dw(x, dy, k), K.conv_dw(x, dy, k)
        want = conv_dw_plain(x, dy, k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"conv_dw case {name} x {tuple(shape)} k {k}: max |kernel - "
              f"plain| {err:.3e}, max |plain| {scale:.3e}, rerun "
              f"bit-identical {torch.equal(got, again)} (tolerance "
              f"{DW_TOL} max |plain|)")
        if not err <= DW_TOL * scale or not torch.equal(got, again):
            raise AssertionError(f"conv_dw disagrees on case {name}")
        max_err = max(max_err, err)

    # times at the probe's and the train step's shapes, in turns
    old = old_kernels().get("conv_dw")
    timer = {"plain": cuda_ms, "cuDNN": graph_ms, "kernel": graph_ms,
             "parent kernel": graph_ms}
    reps = {"plain": 3, "cuDNN": 20, "kernel": 20, "parent kernel": 20}
    times = {}
    for label, shape in DW_TIMED.items():
        x, dy = randn(shape), randn(shape)
        fns = {"plain": lambda: conv_dw_plain(x, dy, 3),
               "cuDNN": lambda: dw_cudnn(x, dy, 3),
               "kernel": lambda: K.conv_dw(x, dy, 3),
               **({"parent kernel": lambda: old(x, dy, 3)} if old else {})}
        want = fns["plain"]()
        err = float((fns["kernel"]() - want).abs().max())
        if not err <= DW_TOL * float(want.abs().max()):
            raise AssertionError(f"conv_dw disagrees at {shape}")
        max_err = max(max_err, err)
        got = in_turns(fns, timer, reps)
        times[label] = (sum(got["kernel"]) / 2, sum(got["plain"]) / 2,
                        sum(got["cuDNN"]) / 2)
        print(f"time conv_dw {label} {shape} k 3 bf16: " + ", ".join(
            f"{what} {a:.4f} / {b:.4f} ms" for what, (a, b) in got.items())
            + f"; max |kernel - plain| {err:.3e}"
            + ("" if old else "; no parent tree under build/old"))
    return max_err, times[DW_MAIN]


def trainer(model_dtype, state, device=None, mesh=None, model=None,
            **kwargs):
    """A UNetTrainer at the JAX config's defaults (mapping_tpu/config.py:
    ResNet101, 32 filters, deconv, 2 classes, weighted loss w0 50, sigma
    10, dice 0.2 softmax with smooth 1, CE 1.0, Adam lr 5e-4 with L2 1e-4
    on conv kernels, flat rate) holding the weights `state`; `mesh`,
    `model` (model_params over the defaults) and UNetTrainer's other
    arguments as given."""
    from mapping_tpu_torch.train.trainer import UNetTrainer

    args = dict(
        model_params={"encoder": "ResNet101", "dtype": model_dtype,
                      **(model or {})},
        optimizer_params={"lr": 5e-4, "gamma": 1.0, "weight_decay": 1e-4},
        loss_params={"w0": 50, "sigma": 10, "imsize": TRAIN_SIZE,
                     "dice_weight": 0.2, "bce_weight": 1.0, "smooth": 1,
                     "dice_activation": "softmax"},
        training_config={"epochs": 1, "steps_per_call": 1},
        input_size=TRAIN_SIZE, device=device or DEVICE, mesh=mesh)
    t = UNetTrainer(**{**args, **kwargs})
    t.model.load_state_dict(state)
    return t


class ResidentSet:
    """The resident set of this process in MiB, from /proc/self/statm: at
    the start of the with-block and its peak, sampled every 10 ms on a
    thread, over the block."""

    @staticmethod
    def mib():
        pages = int(Path("/proc/self/statm").read_text().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20

    def __enter__(self):
        self.start = self.peak = self.mib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self.mib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.mib())


def train_phase(gen, smi, prepared):
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.data.loader import (SegmentationLoader,
                                               in_memory_train_flow,
                                               load_image, load_target)
    from mapping_tpu_torch.data.metadata import read_metadata
    from mapping_tpu_torch.kernels import ccl, conv_dw
    from mapping_tpu_torch.ops.conv_dw import conv_dw_plain
    from mapping_tpu_torch.tools.dw_probe import train_step_dw

    # the files phase 6 wrote, through the metadata as the train command
    # reads them
    cli.main(["--config", prepared["config"], "prepare_metadata", "-tr"])
    rows = read_metadata(prepared["meta_dir"] / "metadata.csv")
    n = (TRAIN_STEPS + 1) * BATCH
    x = [r["file_path_image"] for r in rows[:n]]
    y = [r["file_path_mask_eroded_0_dilated_0"] for r in rows[:n]]

    def loader(mode="resize", augment=True):
        return SegmentationLoader(mode=mode, size=TRAIN_SIZE,
                                  batch_size_train=BATCH, seed=5,
                                  augment=augment, device=DEVICE)

    def first_batch(mode, augment):
        flow, _ = loader(mode, augment).transform(x[:BATCH],
                                                  y[:BATCH])["datagen"]
        batch = next(iter(flow))
        flow.close()
        return batch

    one = first_batch("resize", False)
    tiles = np.stack([load_image(p) for p in x[:BATCH]])
    print(f"train: targets read from the files of phase 6 "
          f"({Path(y[0]).parent}); foreground share "
          f"{float(one['target'][..., 0].mean()):.3f}, sqrt(size) max "
          f"{float(one['target'][..., 2].max()):.1f}")
    state = random_model(101, gen).state_dict()
    tr = trainer("bfloat16", state)
    tr.fit(([one], 1))  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    ccl.reset_launches()
    conv_dw.reset_launches()
    # the slice: one epoch of augmented batches read from the files, the
    # dW probe on one bf16 step's tensors, and serving the trained weights
    files = loader()
    flow = files.transform(x[BATCH:], y[BATCH:])["datagen"]
    with ResidentSet() as rss:
        start = time.perf_counter()
        tr.fit(flow)
        seconds = time.perf_counter() - start
    losses = tr.train_losses
    # the same epoch from files and from host memory, in turns: what
    # reading the files on the prefetch thread costs the step
    held = (np.stack([load_image(p) for p in x[BATCH:]]),
            np.stack([load_target(p) for p in y[BATCH:]]))
    epochs = {
        "files": lambda: loader().transform(x[BATCH:], y[BATCH:])["datagen"],
        "memory": lambda: in_memory_train_flow(
            *held, BATCH, TRAIN_SIZE, torch.Generator().manual_seed(1),
            device=DEVICE)}

    def epoch_ms(make, _):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        tr.fit(make())
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - begin) / len(tr.train_losses)

    per_step = in_turns(epochs, {k: epoch_ms for k in epochs},
                        {k: None for k in epochs})
    print("train: ms/step of an epoch read from " + ", ".join(
        f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in per_step.items())
        + f" (in turns, host clock) on {smi}")
    captured = train_step_dw(tr, one, ["dec0.conv", "dec1.block.0.conv"])
    pipe = pipeline({"encoder": "ResNet101", "model_dtype": "bfloat16",
                     "batch_size_inference": BATCH}, tr.state_dict())
    rows = list(pipe.transform_arrays(tiles))
    torch.cuda.synchronize()
    launches = {**ccl.LAUNCHES, **conv_dw.LAUNCHES}
    print(f"train: ResNet101 bf16, {len(losses)} steps of {BATCH} tiles "
          f"300^2 -> {TRAIN_SIZE[0]}^2 with augmentation, read from files on "
          f"the prefetch thread, in {seconds:.4f} s: "
          f"{1e3 * seconds / len(losses):.2f} ms/step, "
          f"{BATCH * len(losses) / seconds:.2f} images/s (the loss is read "
          f"back to the host after every step, included) on {smi}")
    print(f"train: resident set of this process over the epoch: "
          f"{rss.start:.1f} MiB at its start, peak {rss.peak:.1f} MiB "
          f"(/proc/self/statm every 10 ms); decode on the prefetch thread "
          f"{files.decode_seconds / len(losses) * 1e3:.2f} ms per batch of "
          f"{BATCH} tiles and targets")
    print(f"train: losses {[round(l, 5) for l in losses]}")
    print(f"train: launches in that run {launches}")
    if len(losses) < TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"bad losses {losses}")
    if min(launches.values()) < 1:
        raise AssertionError("the slice did not go through every kernel")
    if len(rows) != BATCH or any(lab.shape != (2, TILE, TILE)
                                 for lab, _ in rows):
        raise AssertionError("the trained weights did not serve the batch")
    print(f"train: served {len(rows)} tiles with the trained weights, "
          f"instances per image max {max(len(t[1]) for _, t in rows)}")

    # one crop_and_pad batch: random 256^2 crops of the augmented tiles
    crop = first_batch("crop_and_pad", True)
    tr.fit(([crop], 1))
    print(f"train: one crop_and_pad batch {tuple(crop['image'].shape)}, "
          f"loss {tr.train_losses[0]:.5f}")
    if crop["target"].shape != (BATCH,) + TRAIN_SIZE + (3,) \
            or not np.isfinite(tr.train_losses).all():
        raise AssertionError("the crop_and_pad batch did not train")

    # the dW kernel on the step's own tensors
    for name, got in captured.items():
        plain = conv_dw_plain(got["x"], got["dy"], 3)
        scale = float(plain.abs().max())
        e_plain = float((got["kernel"] - plain).abs().max())
        e_auto = float((got["kernel"] - got["autograd"]).abs().max())
        print(f"train: conv_dw on {name} x {tuple(got['x'].shape)}: max "
              f"|kernel - plain| {e_plain:.3e}, max |kernel - autograd "
              f"(cuDNN bf16)| {e_auto:.3e}, max |plain| {scale:.3e} "
              f"(tolerances {DW_TOL} and {DW_AUTOGRAD_TOL} max |plain|)")
        if not (e_plain <= DW_TOL * scale and e_auto <= DW_AUTOGRAD_TOL * scale):
            raise AssertionError(f"conv_dw disagrees on {name}'s tensors")

    # the loss falls over 5 steps on one un-augmented batch repeated
    tr.fit(([one] * 5, 5))
    print(f"train: 5 steps on one batch, losses "
          f"{[round(l, 5) for l in tr.train_losses]}")
    if not tr.train_losses[-1] < tr.train_losses[0]:
        raise AssertionError("the loss did not fall on a repeated batch")

    # one float32 step on the card against one on the CPU, 2 tiles
    two = {k: v[:2] for k, v in one.items()}
    steps = {}
    for device in (DEVICE, "cpu"):
        t32 = trainer("float32", state, device)
        t32.fit(([{k: v.to(device) for k, v in two.items()}], 1))
        steps[device] = (t32.train_losses[0], t32.state_dict())
    (l_card, s_card), (l_cpu, s_cpu) = steps[DEVICE], steps["cpu"]
    e_stat = max(float((s_card[k] - s_cpu[k]).abs().max())
                 / float(s_cpu[k].abs().max()) for k in s_cpu if "running" in k)
    print(f"train: float32 step card vs CPU: loss {l_card:.6f} vs "
          f"{l_cpu:.6f} (relative {abs(l_card - l_cpu) / abs(l_cpu):.3e}, "
          f"tolerance 1e-4), BatchNorm running statistics max |diff| "
          f"{e_stat:.3e} of each tensor's max (tolerance 1e-3)")
    if not (abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu) and e_stat <= 1e-3):
        raise AssertionError("float32 train step on the card disagrees")
    return launches


def synthetic_fixture():
    """tests/fixtures/synthetic.py, loaded by path: an installed package
    named `tests` may shadow the repository's."""
    spec = importlib.util.spec_from_file_location(
        "synthetic_fixture", ROOT / "tests" / "fixtures" / "synthetic.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    return fixture


def crowded_tile(rng, n=PREP_CROWDED, side=8, step=20):
    """A tile of n bright side x side buildings on a grid of `step`
    pixels, and their annotations."""
    tile = rng.randint(30, 90, (TILE, TILE, 3)).astype(np.uint8)
    spots = [(y, x) for y in range(6, TILE - side - 5, step)
             for x in range(6, TILE - side - 5, step)]
    anns = []
    for k in rng.permutation(len(spots))[:n]:
        y0, x0 = spots[k]
        tile[y0:y0 + side, x0:x0 + side] = 220
        x1, y1 = float(x0 + side), float(y0 + side)
        anns.append({"segmentation": [[float(x0), float(y0), x1, float(y0),
                                       x1, y1, float(x0), y1]],
                     "area": float(side * side),
                     "bbox": [float(x0), float(y0), float(side), float(side)],
                     "iscrowd": 0, "category_id": 100})
    return tile, anns


def write_split(root, split, n, rng, extra=(), fmt="png"):
    """The `extra` (tile, annotations) pairs, then n synthetic CrowdAI-style
    300^2 tiles (up to 20 buildings each), as root/split/images/*.png, or
    *.jpg with `fmt` "jpeg" (the port's encoder at quality 95, 4:2:0, as
    the CrowdAI tiles are), written on 8 threads, with
    root/split/annotation.json; returns the tiles."""
    from mapping_tpu_torch.utils import jpeg
    from mapping_tpu_torch.utils.png import encode_png

    suffix, encode = ((".jpg", lambda t: jpeg.encode(t, 95, "4:2:0"))
                      if fmt == "jpeg" else (".png", encode_png))

    fixture = synthetic_fixture()
    images = root / split / "images"
    images.mkdir(parents=True)
    dataset = {"images": [], "annotations": [], "categories": [
        {"id": 100, "name": "building", "supercategory": "building"}]}
    pairs = list(extra) + [fixture._make_image(rng, h=TILE, w=TILE,
                                               max_buildings=20)
                           for _ in range(n)]
    for i, (tile, anns) in enumerate(pairs):
        name = f"{split}_{i:05d}{suffix}"
        dataset["images"].append({"id": i + 1, "file_name": name,
                                  "height": TILE, "width": TILE})
        for ann in anns:
            dataset["annotations"].append(
                {**ann, "id": len(dataset["annotations"]) + 1,
                 "image_id": i + 1})
    with ThreadPoolExecutor(8) as pool:  # zlib, numpy, g++ code
        list(pool.map(lambda i: (images / f"{split}_{i:05d}{suffix}")
                      .write_bytes(encode(pairs[i][0])), range(len(pairs))))
    (root / split / "annotation.json").write_text(json.dumps(dataset))
    return np.stack([tile for tile, _ in pairs])


def sub_split(root, split, name, n):
    """root/name/annotation.json: the first n images of `split` (no image
    files: overlay_masks reads only the annotations)."""
    doc = json.loads((root / split / "annotation.json").read_text())
    keep = {img["id"] for img in doc["images"][:n]}
    doc["images"] = doc["images"][:n]
    doc["annotations"] = [a for a in doc["annotations"]
                          if a["image_id"] in keep]
    (root / name).mkdir()
    (root / name / "annotation.json").write_text(json.dumps(doc))


def write_config(name, params, where=EVAL_DIR):
    """A parameter file (neptune.yaml layout) of `params`."""
    path = where / f"{name}.yaml"
    path.write_text("parameters:\n" + "".join(
        f"  {k}: {json.dumps(v)}\n" for k, v in params.items()))
    return str(path)


def check_prediction(path, image_ids, what, allow_empty=False):
    """prediction.json parses, holds 300^2 masks of the expected images,
    and finite scores; returns it."""
    prediction = json.loads(Path(path).read_text())
    if not prediction and not allow_empty:
        raise AssertionError(f"{what}: empty prediction")
    for p in prediction:
        if p["segmentation"]["size"] != [TILE, TILE] \
                or p["image_id"] not in image_ids \
                or not math.isfinite(p["score"]):
            raise AssertionError(f"{what}: bad instance {p}")
    print(f"evaluate: {what}: {len(prediction)} instances on "
          f"{len({p['image_id'] for p in prediction})} images")
    return prediction


def last_scores(experiment):
    """(AP, AR) of the last evaluate, from metrics.jsonl."""
    lines = (experiment / "metrics.jsonl").read_text().splitlines()[-2:]
    scores = {json.loads(l)["channel"]: json.loads(l)["y"] for l in lines}
    ap, ar = scores["Precision"], scores["Recall"]
    if not (0.0 <= ap <= 1.0 and 0.0 <= ar <= 1.0):
        raise AssertionError(f"AP/AR out of range: {ap}, {ar}")
    return ap, ar


def run_child(args, log):
    """Run `args` from the checkout with its output in `log`; returns
    (exit code, seconds, the child's peak RSS in MiB from wait4's
    rusage). Killed after 900 s."""
    start = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(args, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
        timer = threading.Timer(900, proc.kill)
        timer.start()
        try:
            _, status, usage = os.wait4(proc.pid, 0)
        finally:
            timer.cancel()
    proc.returncode = os.waitstatus_to_exitcode(status)
    return (proc.returncode, time.perf_counter() - start,
            usage.ru_maxrss / 1024)


def read_targets(target_dir, split):
    """{stem: (mask, distances, sizes)} of the files under target_dir."""
    from mapping_tpu_torch.utils import ndpickle
    from mapping_tpu_torch.utils.png import read_png_gray

    out = {}
    for path in sorted((target_dir / split / "masks").iterdir()):
        out[path.stem] = (read_png_gray(path),) + tuple(
            ndpickle.load(target_dir / split / sub / path.stem)
            for sub in ("distances", "sizes"))
    return out


def oracle_targets(masks, erode=0, dilate=0, border_width=0,
                   small_annotations_size=14):
    """The reference's rules with scipy: (mask uint8, distances float64,
    sizes) of decoded annotation masks. Erosion and dilation are k x k
    minimum and maximum filters anchored as skimage anchors an even
    footprint (the dilation's window mirrored); objects only in the
    2-pixel frame are dropped; erosion applies to objects of more than
    small_annotations_size^2 pixels, and erased ones come back unless
    dilate > 0, which dilates the small ones; distances are the two
    smallest of distance_transform_edt over the objects; sizes are
    component areas, 1 on the background."""
    from scipy import ndimage

    objects = []
    for m in masks:
        m = m.astype(np.uint8)
        if not m[2:-2, 2:-2].any():
            continue
        p = m
        if erode > 0 and m.sum() > small_annotations_size ** 2:
            p = ndimage.minimum_filter(m, size=erode, mode="constant", cval=1)
            if dilate == 0 and not p.any():
                p = m
        elif erode > 0 and dilate > 0:
            p = ndimage.maximum_filter(m, size=dilate, mode="constant",
                                       cval=0, origin=-(1 - dilate % 2))
        objects.append(p.astype(bool))
    if not objects:
        return (np.zeros((TILE, TILE), np.uint8), np.zeros((TILE, TILE)),
                np.ones((TILE, TILE), np.int64))
    d = np.sort([ndimage.distance_transform_edt(~p) for p in objects], 0)
    second = d[1] if len(objects) > 1 else d[0]
    mask = np.any(objects, 0)
    labels, _ = ndimage.label(mask)
    counts = np.bincount(labels.ravel())
    counts[0] = 1
    out = mask.astype(np.uint8)
    if border_width > 0:
        out[(second < border_width) & ~mask] = out.max() + 1
    return out, d[0] + second, counts[labels]


def cuda_timed(fn, events):
    """`fn` recording a pair of CUDA events around each call into
    `events`."""
    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    return timed


def prepare_phase(smi):
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.data.coco import COCOIndex
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.prep import targets

    shutil.rmtree(PREP_DIR, ignore_errors=True)
    data, meta = PREP_DIR / "data", PREP_DIR / "meta"
    rng = np.random.RandomState(9)
    empty = (rng.randint(30, 90, (TILE, TILE, 3)).astype(np.uint8), [])
    start = time.perf_counter()
    write_split(data, "train", PREP_TRAIN, rng,
                extra=[crowded_tile(rng), empty])
    write_split(data, "val", PREP_VAL, rng)
    n_train, n_images = PREP_TRAIN + 2, PREP_TRAIN + 2 + PREP_VAL
    print(f"prepare: wrote {n_images} PNG tiles of {TILE}^2 (train "
          f"{n_train}: a crowded tile of {PREP_CROWDED} buildings and an "
          f"empty one among them; val {PREP_VAL}) in "
          f"{time.perf_counter() - start:.2f} s")
    config = write_config("prepare", {
        "data_dir": str(data), "meta_dir": str(meta),
        "experiment_dir": str(PREP_DIR / "experiment"), "device": DEVICE},
        PREP_DIR)

    # the CLI as a user runs it, at the JAX defaults
    rc, seconds, child_rss = run_child(
        [sys.executable, "-m", "mapping_tpu_torch.main", "--config", config,
         "prepare_masks"], PREP_DIR / "prepare_masks.log")
    if rc != 0:
        raise AssertionError("prepare_masks failed:\n" + (
            PREP_DIR / "prepare_masks.log").read_text()[-3000:])
    written = meta / "masks_overlayed_eroded_0_dilated_0"
    want = {"train": n_train, "val": PREP_VAL}
    counts = {(split, sub): len(list((written / split / sub).iterdir()))
              for split in want for sub in ("masks", "distances", "sizes")}
    _, _, context_rss = run_child(
        [sys.executable, "-c", "import torch; torch.zeros(1, device='cuda')"
         "; torch.cuda.synchronize()"], PREP_DIR / "context.log")
    print(f"prepare: CLI child `prepare_masks` exited 0: {n_images} tiles "
          f"in {seconds:.2f} s of wall time, {n_images / seconds:.2f} "
          f"images/s, peak RSS of the child {child_rss:.1f} MiB (wait4; a "
          f"child that only makes the CUDA context peaks at "
          f"{context_rss:.1f} MiB) on {smi}")
    if any(n != want[split] for (split, _), n in counts.items()):
        raise AssertionError(f"prepare_masks wrote {counts} files")

    # the same leg in this process over the train split: the labelling
    # and the whole device function timed with CUDA events, the decode and
    # the writes with the host clock on the pool's threads
    events, device, host, launches = [], [], {"decode": 0.0, "write": 0.0}, {}
    lock = threading.Lock()

    def host_timed(fn, what):
        def timed(*args):
            start = time.perf_counter()
            out = fn(*args)
            with lock:
                host[what] += time.perf_counter() - start
            return out
        return timed

    saved = (targets.connected_components, targets.prepare_batch,
             targets.write_artifacts, COCOIndex.ann_to_mask)
    largest = []  # the largest batch of masks labelled, for graph timing

    def labels(mask):
        if not largest or mask.numel() > largest[0].numel():
            largest[:] = [mask.clone()]
        return saved[0](mask)

    targets.connected_components = cuda_timed(labels, events)
    targets.prepare_batch = cuda_timed(saved[1], device)
    targets.write_artifacts = host_timed(saved[2], "write")
    COCOIndex.ann_to_mask = host_timed(saved[3], "decode")
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        with ResidentSet() as rss:
            start = time.perf_counter()
            targets.overlay_masks(str(data), "train",
                                  str(PREP_DIR / "inproc"), CATEGORY_IDS,
                                  num_threads=8, device=DEVICE)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
    finally:
        (targets.connected_components, targets.prepare_batch,
         targets.write_artifacts, COCOIndex.ann_to_mask) = saved
    launches["defaults"] = dict(K.LAUNCHES)
    label_ms = sum(s.elapsed_time(e) for s, e in events)
    device_ms = sum(s.elapsed_time(e) for s, e in device)
    print(f"prepare: in process, train split at the defaults: {n_train} "
          f"tiles in {seconds:.2f} s ({n_train / seconds:.2f} images/s); "
          f"{len(events)} label calls (one per batch, the crowded tile's "
          f"merge one more), {label_ms / len(events):.4f} ms of device "
          f"time each, {label_ms:.2f} ms in all: "
          f"{label_ms / 1e3 / seconds:.5f} of the leg; {len(device)} "
          f"prepare_batch calls {device_ms:.2f} ms from first to last "
          f"kernel of each (EDT, morphology, CCL, sizes; "
          f"{device_ms / 1e3 / seconds:.4f} of the leg); annotation decode "
          f"{host['decode']:.2f} s and file writes {host['write']:.2f} s "
          f"of host time summed over the 8 pool threads; CCL launches "
          f"{launches['defaults']} (event spans include the host's launch "
          f"gaps); resident set {rss.start:.1f} MiB at the start, peak "
          f"{rss.peak:.1f} MiB (/proc/self/statm every 10 ms)")
    ccl_times(largest[0], "prepare masks", old_kernels(), plain=False)
    inproc, child = (read_targets(d, "train")
                     for d in (PREP_DIR / "inproc", written))
    if inproc.keys() != child.keys() or not all(
            np.array_equal(a, b) for stem in child
            for a, b in zip(inproc[stem], child[stem])):
        raise AssertionError("the in-process leg and the CLI child wrote "
                             "different files")

    # the other modes on a sample of the train split
    sub_split(data, "train", "sample", PREP_SAMPLE)
    for name, mode in PREP_MODES.items():
        torch.cuda.synchronize()
        K.reset_launches()
        start = time.perf_counter()
        targets.overlay_masks(str(data), "sample", str(PREP_DIR / name),
                              CATEGORY_IDS, num_threads=8, device=DEVICE,
                              **mode)
        torch.cuda.synchronize()
        launches[name] = dict(K.LAUNCHES)
        print(f"prepare: in process, {PREP_SAMPLE} tiles with {mode} in "
              f"{time.perf_counter() - start:.2f} s; CCL launches "
              f"{launches[name]}")
    if min(min(v.values()) for v in launches.values()) < 1:
        raise AssertionError(f"prepare did not launch the CCL kernels: "
                             f"{launches}")

    # 20 tiles, every mode: card = CPU = plain CCL, and scipy's oracle
    sub_split(data, "train", "checked", PREP_CHECKED)
    coco = COCOIndex(str(data / "checked" / "annotation.json"))
    decoded = {coco.load_imgs([i])[0]["file_name"][:-4]: [
        coco.ann_to_mask(a) for a in coco.load_anns(coco.get_ann_ids(
            img_ids=[i]))] for i in coco.get_img_ids()}

    def plain(mask):
        return _renumber(_label_raw(mask != 0, mask.shape[-2]
                                    + mask.shape[-1]))

    for name, mode in {"defaults": {}, **PREP_MODES}.items():
        out = {}
        for path in ("card", "cpu", "plain"):
            target_dir = PREP_DIR / "checked" / f"{name}_{path}"
            if path == "plain":
                targets.connected_components = plain
            try:
                targets.overlay_masks(str(data), "checked", str(target_dir),
                                      CATEGORY_IDS, device="cpu"
                                      if path == "cpu" else DEVICE, **mode)
            finally:
                targets.connected_components = saved[0]
            out[path] = read_targets(target_dir, "checked")
        for path in ("cpu", "plain"):
            for stem, files in out["card"].items():
                if not all(np.array_equal(a, b) and a.dtype == b.dtype
                           for a, b in zip(files, out[path][stem])):
                    raise AssertionError(f"prepare {name}: card differs from "
                                         f"{path} on {stem}")
        err = 0.0
        for stem, masks in decoded.items():
            mask, dist, sizes = oracle_targets(masks, **mode)
            got_mask, got16, got_sizes = out["card"][stem]
            got = prepare_targets_f32(targets, masks, mode)
            if not (np.array_equal(got_mask, mask)
                    and np.array_equal(got_sizes, sizes)
                    and np.array_equal(got.astype(np.float16), got16)):
                raise AssertionError(f"prepare {name}: {stem} differs from "
                                     f"scipy's masks or sizes")
            rel = np.abs(got - dist) / np.maximum(dist, 1e-30)
            err = max(err, float(rel[dist > 0].max(initial=0.0)))
            if (got[dist == 0] != 0).any() or err > PREP_REL_TOL:
                raise AssertionError(f"prepare {name}: {stem} distances off "
                                     f"scipy's by {err:.3e}")
        print(f"prepare: {name}: {PREP_CHECKED} tiles, card = CPU = plain "
              f"CCL (masks, sizes, float16 distances exact); = scipy "
              f"(masks and sizes exact, distances max relative error "
              f"{err:.3e}, tolerance {PREP_REL_TOL})")
    return {"config": config, "meta_dir": meta,
            "launches": {k: sum(v[k] for v in launches.values())
                         for k in K.LAUNCHES}}


def prepare_targets_f32(targets, masks, mode):
    """The card's float32 distances of one tile's objects: prepare_batch
    with every object in one stack (what the chunked path gives, exactly,
    for more than MAX_OBJECTS)."""
    if not masks:
        return np.zeros((TILE, TILE), np.float32)
    stack = torch.from_numpy(np.stack(masks).astype(bool))[None].to(DEVICE)
    rules = {k: mode.get(k, 0) for k in ("erode", "dilate", "border_width")}
    _, dist, _, _ = targets.prepare_batch(
        stack, torch.ones(stack.shape[:2], dtype=torch.bool, device=DEVICE),
        rules["erode"], rules["dilate"], 14, rules["border_width"])
    return dist[0].cpu().numpy()


def evaluate_phase(gen, smi):
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.coco import COCOIndex
    from mapping_tpu_torch.data.loader import infer_batch_resize, load_image
    from mapping_tpu_torch.eval.cocoeval import coco_evaluation
    from mapping_tpu_torch.infer import postprocess
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.utils import native_decode

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    data, experiment = EVAL_DIR / "data", EVAL_DIR / "experiment"
    tiles = write_split(data, "val", EVAL_TILES, np.random.RandomState(8))
    gt_path = data / "val" / "annotation.json"
    image_ids = set(range(1, EVAL_TILES + 1))
    print(f"evaluate: libpng (cpp/decode.cpp) "
          f"{'built' if native_decode.available() else 'unavailable: PNG goes through the stdlib reader'}; "
          f"tiles are PNG (phase 16 runs them as JPEG)")
    small = load_image(JPEG_CORPUS / "size_16x16.jpg")
    if small.shape != (16, 16, 3):
        raise AssertionError(f"a JPEG decoded to {small.shape}")
    fake_jpeg = EVAL_DIR / "not_decodable.jpg"
    fake_jpeg.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    try:
        load_image(fake_jpeg)
    except ValueError as e:
        print(f"evaluate: a JPEG decodes through the port's decoder; a "
              f"64-byte fake one raises: {e}")
    else:
        raise AssertionError("a 64-byte fake JPEG decoded")

    base = {"data_dir": str(data), "meta_dir": str(EVAL_DIR / "meta"),
            "experiment_dir": str(experiment), "device": DEVICE,
            **EVAL_PARAMS}
    configs = {
        "default": write_config("default", base),
        "erode3_dilate2": write_config("erode3_dilate2", {
            **base, "erode_selem_size": 3, "dilate_selem_size": 2}),
        "crop_and_pad_reflect": write_config("crop_and_pad_reflect", {
            **base, "loader_mode": "crop_and_pad", "pad_method": "reflect"}),
    }
    probe = infer_batch_resize(torch.from_numpy(tiles[:BATCH]).to(DEVICE),
                               (256, 256))
    state = centre_logits(random_model(EVAL_DEPTH, gen), probe)
    checkpoint = EVAL_DIR / "reference.pth"
    torch.save(state, checkpoint)
    cli.main(["--config", configs["default"], "prepare_metadata", "-val"])
    cli.main(["--config", configs["default"], "import_checkpoint", "-p",
              "unet_weighted", "--path", str(checkpoint)])

    # the CLI as a user runs it
    start = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mapping_tpu_torch.main", "--config",
         configs["default"], "evaluate", "-p", "unet_weighted"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"the CLI failed:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    print(f"evaluate: CLI subprocess `evaluate -p unet_weighted` exited 0 "
          f"in {time.perf_counter() - start:.2f} s; its log ends:")
    for line in out.stdout.strip().splitlines()[-4:]:
        print(f"evaluate:   {line}")
    check_prediction(experiment / "prediction.json", image_ids,
                     "CLI subprocess")
    print(f"evaluate: CLI subprocess AP/AR {last_scores(experiment)}")

    runs = {}
    for name in configs:
        torch.cuda.synchronize()
        K.reset_launches()
        manager = cli.main(["--config", configs[name], "evaluate", "-p",
                            "unet_weighted"])
        torch.cuda.synchronize()
        runs[name] = (manager.timings, dict(K.LAUNCHES))
        check_prediction(experiment / "prediction.json", image_ids, name)
        print(f"evaluate: {name}: AP/AR {last_scores(experiment)}, CCL "
              f"launches {runs[name][1]}, host seconds {manager.timings}")
    K.reset_launches()
    manager = cli.main(["--config", configs["default"], "predict_on_dir",
                        "-p", "unet_weighted", "--dir_path",
                        str(data / "val" / "images"), "--prediction_path",
                        str(EVAL_DIR / "predict_on_dir.json")])
    torch.cuda.synchronize()
    runs["predict_on_dir"] = (manager.timings, dict(K.LAUNCHES))
    check_prediction(EVAL_DIR / "predict_on_dir.json",
                     set(range(EVAL_TILES)), "predict_on_dir")
    print(f"evaluate: predict_on_dir: CCL launches {runs['predict_on_dir'][1]}")
    for name, (timings, launches) in runs.items():
        if timings["images"] != EVAL_TILES or min(launches.values()) < 1:
            raise AssertionError(f"{name}: {timings['images']} images, "
                                 f"launches {launches}")
    l_plain, l_erode = runs["default"][1], runs["erode3_dilate2"][1]
    if any(l_erode[k] != 2 * l_plain[k] for k in l_plain):
        raise AssertionError(f"erosion should double the CCL launches: "
                             f"{l_plain} -> {l_erode}")
    t = runs["default"][0]
    print(f"evaluate: default run, {t['images']} images in "
          f"{t['total_s']:.4f} s: {t['images'] / t['total_s']:.2f} images/s "
          f"end to end; decode {t['decode_s']:.4f} s (loader threads), "
          f"device (dispatch to collect) {t['device_s']:.4f} s, annotation "
          f"+ RLE {t['annotation_s']:.4f} s, COCOeval {t['cocoeval_s']:.4f} "
          f"s (host clock) on {smi}")

    # kernel path = plain path under erosion and dilation, on one batch's
    # probabilities resized to 300^2 on the card
    pipe = pipeline({"model_dtype": "bfloat16", **EVAL_PARAMS}, state)
    probs = resize_bilinear(probs_of(pipe, tiles[:BATCH]), (TILE, TILE))
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=(1,), erode_size=3, dilate_size=2)
    kernel = postprocess.fused_postprocess(probs, **post)
    saved = postprocess.connected_components
    postprocess.connected_components = lambda mask: _renumber(
        _label_raw(mask != 0, mask.shape[-2] + mask.shape[-1]))
    try:
        plain = postprocess.fused_postprocess(probs, **post)
    finally:
        postprocess.connected_components = saved
    if not (torch.equal(kernel[0], plain[0]) and torch.equal(kernel[2],
                                                             plain[2])
            and torch.allclose(kernel[1], plain[1], rtol=1e-5, atol=0)):
        raise AssertionError("erode/dilate postprocess: kernel path differs "
                             "from the plain path")
    print(f"evaluate: erode 3 + dilate 2 postprocess, kernel path = plain "
          f"path on one batch ({int(kernel[0].amax())} instances max; labels "
          f"and areas exact, scores 1e-5 relative)")
    old = old_kernels()
    ccl_times(probs[..., 1] > 0.5, "evaluate masks", old, plain=False)
    # the buildings themselves: tiles brighter than any background pixel
    buildings = torch.from_numpy(tiles[:BATCH].min(-1) > 120).to(DEVICE)
    ccl_times(buildings, "building footprints", old, plain=False)

    # the evaluator on the split's ground truth, written as predictions
    coco = COCOIndex(str(gt_path))
    dets = []
    for ann in coco.anns.values():
        rle = coco.ann_to_rle(ann)
        dets.append({"image_id": ann["image_id"], "category_id": 100,
                     "score": 1.0, "segmentation": {
                         "size": rle["size"],
                         "counts": rle["counts"].decode()}})
    gt_pred = EVAL_DIR / "ground_truth_as_prediction.json"
    gt_pred.write_text(json.dumps(dets))
    ap, ar = coco_evaluation(str(gt_path), str(gt_pred), coco.get_img_ids(),
                             [100], verbose=False)
    print(f"evaluate: ground truth as predictions ({len(dets)} instances): "
          f"AP {ap} AR {ar}")
    if not ap == ar == 1.0:
        raise AssertionError("ground truth as predictions must score 1")
    return ({k: sum(launches[k] for _, launches in runs.values())
             for k in K.LAUNCHES}, runs["default"][0])


def cli_child(config, *command):
    return [sys.executable, "-c", CLI_CHILD, "--config", config, *command]


def run_cli(config, log, *command):
    """A CLI_CHILD of `command` that must exit 0: (seconds, the CCL launch
    counts it printed)."""
    rc, seconds, _ = run_child(cli_child(config, *command), log)
    last = log.read_text().strip().splitlines()[-1]
    if rc != 0 or not last.startswith("ccl launches "):
        raise AssertionError(f"{' '.join(command)} exited {rc}:\n"
                             + log.read_text()[-3000:])
    return seconds, json.loads(last[len("ccl launches "):])


def resume_files(checkpoint_dir):
    """(last.pt's dict, read back with weights_only, and the sidecar
    JSON beside it)."""
    payload = torch.load(checkpoint_dir / "last.pt", map_location="cpu",
                         weights_only=True)
    return payload, json.loads((checkpoint_dir / "last.pt.aux.json")
                               .read_text())


def kill_at_first_resume_save(args, log, aux):
    """Start `args` and SIGKILL it as soon as the resume sidecar `aux`
    appears; returns the epoch_id the sidecar shows."""
    with open(log, "w") as out:
        proc = subprocess.Popen(args, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 600
            while not aux.exists():
                if proc.poll() is not None:
                    raise AssertionError(f"exited {proc.returncode} before "
                                         f"its first resume save")
                if time.monotonic() > deadline:
                    raise AssertionError("no resume save in 600 s")
                time.sleep(0.02)
            proc.kill()
            return json.loads(aux.read_text())["epoch_id"]
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def train_cli_phase(smi, prepared):
    import hashlib

    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.kernels import ccl as K

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    steps = -(-(PREP_TRAIN + 2) // BATCH)
    dev_steps = -(-min(20, PREP_TRAIN + 2) // BATCH)  # dev mode: 20 rows

    def config(name, **extra):
        return write_config(name, {
            "data_dir": str(PREP_DIR / "data"),
            "meta_dir": str(prepared["meta_dir"]),
            "experiment_dir": str(TRAIN_DIR / name), "device": DEVICE,
            **TRAIN_CLI_PARAMS, **extra}, TRAIN_DIR)

    full = config("full")
    cli.main(["--config", full, "prepare_metadata"])  # both splits
    launches = {k: 0 for k in K.LAUNCHES}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    # (a) the train command at full width
    experiment = TRAIN_DIR / "full"
    checkpoints = experiment / "checkpoints" / "unet"
    seconds, got = run_cli(full, TRAIN_DIR / "full.log", "train", "-p",
                           "unet_weighted")
    count(got)
    log = (TRAIN_DIR / "full.log").read_text()
    maps = re.findall(r"epoch (\d+) validation mAP = ([\d.]+) in ([\d.]+) s",
                      log)
    took = [float(t) for t in re.findall(r"epoch \d+ took ([\d.]+)s", log)]
    writes = {what: [float(t) for t in re.findall(
        rf"{what} checkpoint .* in ([\d.]+) s", log)]
        for what in ("best", "resume")}
    metrics = [json.loads(l) for l in
               (experiment / "metrics.jsonl").read_text().splitlines()]
    losses = [m["y"] for m in metrics if m["channel"] == "unet batch loss"]
    val = [m["y"] for m in metrics if m["channel"] == "unet epoch_val sum"]
    payload, aux = resume_files(checkpoints)
    last_mib = (checkpoints / "last.pt").stat().st_size / 2 ** 20
    print(f"train CLI: (a) `train -p unet_weighted` exited 0 in {seconds:.2f} "
          f"s of wall time (child process); {len(took)} epochs of {steps} "
          f"steps of {BATCH} tiles read from files: " + ", ".join(
              f"epoch {e} {1e3 * t / steps:.2f} ms/step, validation mAP "
              f"{float(ap):.5f} in {float(vs):.2f} s on {PREP_VAL} tiles"
              for t, (e, ap, vs) in zip(took, maps))
          + f"; checkpoint writes (s): best.pt {writes['best']}, last.pt "
          f"{writes['resume']} ({last_mib:.1f} MiB) (host clock); CCL "
          f"launches {got} on {smi}")
    files = [experiment / "transformers" / "unet.pt", checkpoints / "best.pt",
             checkpoints / "last.pt", checkpoints / "STAGE_COMPLETE"]
    missing = [f.name for f in files if not f.exists()]
    if missing or aux["epoch_id"] != 1 or payload["aux"] != aux \
            or payload["step"] != 2 * steps:
        raise AssertionError(f"train: missing {missing}, aux {aux}, step "
                             f"{payload['step']}")
    if len(losses) != 2 * steps or not np.isfinite(losses).all() \
            or len(val) != 2 or len(maps) != 2 or min(got.values()) < 1:
        raise AssertionError(f"train: {len(losses)} losses (finite: "
                             f"{np.isfinite(losses).all()}), validation "
                             f"{val}, mAP lines {maps}, launches {got}")

    # (b) a run killed after an epoch before its last, then resumed
    resume = config("resume", epochs_nr=RESUME_EPOCHS)
    checkpoints = TRAIN_DIR / "resume" / "checkpoints" / "unet"
    shown = kill_at_first_resume_save(cli_child(resume, "train", "-d"),
                                      TRAIN_DIR / "killed.log",
                                      checkpoints / "last.pt.aux.json")
    payload, _ = resume_files(checkpoints)
    killed_at = payload["aux"]["epoch_id"]  # written with the state
    if not killed_at < RESUME_EPOCHS - 1 \
            or payload["step"] != (killed_at + 1) * dev_steps:
        raise AssertionError(f"killed run: epoch {killed_at}, step "
                             f"{payload['step']}")
    seconds, got = run_cli(resume, TRAIN_DIR / "resumed.log", "train", "-d")
    count(got)
    log = (TRAIN_DIR / "resumed.log").read_text()
    payload, aux = resume_files(checkpoints)
    print(f"train CLI: (b) `train -d` with {RESUME_EPOCHS} epochs killed "
          f"(SIGKILL) when its sidecar showed epoch {shown} (last.pt: epoch "
          f"{killed_at}); the rerun exited 0 in {seconds:.2f} s, ended at "
          f"epoch {aux['epoch_id']} with {payload['step']} optimizer steps; "
          f"CCL launches {got}")
    if f"resuming epoch schedule at {killed_at + 1}/{RESUME_EPOCHS}" \
            not in log or aux["epoch_id"] != RESUME_EPOCHS - 1 \
            or payload["step"] != RESUME_EPOCHS * dev_steps:
        raise AssertionError("the rerun did not resume the schedule")

    # (c) the next stage, warm-started with another rate
    transformers = TRAIN_DIR / "resume" / "transformers"
    stage1 = hashlib.sha256((transformers / "unet.pt").read_bytes()).digest()
    warm = config("resume", epochs_nr=2, lr=WARM_LR)
    seconds, got = run_cli(warm, TRAIN_DIR / "warm.log", "train", "-w", "-d")
    count(got)
    payload, aux = resume_files(checkpoints)
    lr = payload["optimizer"]["param_groups"][0]["lr"]
    archived = transformers / "unet.stage1.pt"
    print(f"train CLI: (c) `train -w -d` with lr {WARM_LR} exited 0 in "
          f"{seconds:.2f} s: stage 1 archived as {checkpoints.name}.stage1 "
          f"and {archived.name}; the new stage ended at epoch "
          f"{aux['epoch_id']} with {payload['step']} steps at lr {lr}; CCL "
          f"launches {got}")
    if not ((checkpoints.parent / "unet.stage1" / "STAGE_COMPLETE").exists()
            and archived.exists()
            and hashlib.sha256(archived.read_bytes()).digest() == stage1
            and aux["epoch_id"] == 1 and payload["step"] == 2 * dev_steps
            and lr == WARM_LR and (checkpoints / "STAGE_COMPLETE").exists()):
        raise AssertionError("the warm start did not archive stage 1 and "
                             "train a fresh schedule")

    # (d) evaluate the weights of leg (a), in this process
    torch.cuda.synchronize()
    K.reset_launches()
    manager = cli.main(["--config", full, "evaluate", "-p", "unet_weighted"])
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    count(got)
    # two epochs may not yet find a building: no instance is a result
    check_prediction(experiment / "prediction.json",
                     set(range(1, PREP_VAL + 1)), "train CLI (d)",
                     allow_empty=True)
    ap, ar = last_scores(experiment)
    print(f"train CLI: (d) `evaluate -p unet_weighted` on leg (a)'s weights: "
          f"{manager.timings['images']} images, AP {ap} AR {ar}; CCL "
          f"launches {got}")
    if manager.timings["images"] != PREP_VAL or min(got.values()) < 1:
        raise AssertionError(f"evaluate: {manager.timings['images']} "
                             f"images, launches {got}")
    return launches


def scoring_phase(smi, prepared):
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.loader import load_image
    from mapping_tpu_torch.data.tta import tta_specs, tta_wrap_predict
    from mapping_tpu_torch.infer import postprocess
    from mapping_tpu_torch.kernels import bounds
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.pipelines import PIPELINES

    shutil.rmtree(SCORING_DIR, ignore_errors=True)
    experiment = SCORING_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    # phase 9 (a)'s weights: random ones find no building to score
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    launches = {k: 0 for k in K.LAUNCHES}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    def config(name, layers, **extra):
        return write_config(name, {
            "data_dir": str(PREP_DIR / "data"),
            "meta_dir": str(prepared["meta_dir"]),
            "experiment_dir": str(experiment), "device": DEVICE,
            **SCORING_PARAMS, "category_layers": layers, **extra},
            SCORING_DIR)

    # (a) the scoring model's training, from the CLI
    log = SCORING_DIR / "train.log"
    seconds, got = run_cli(config("train", [1, 19]), log, "train", "-p",
                           "scoring_model")
    count(got)
    fit = re.search(r"scoring model: (\d+) feature rows from (\d+) images "
                    r"\(train (\d+), valid (\d+)\); fit in ([\d.]+) s, "
                    r"best_iteration (\d+) of (\d+) trees", log.read_text())
    model_file = experiment / "transformers" / "scoring_model.pkl"
    print(f"scoring: (a) `train -p scoring_model` with category_layers "
          f"[1, 19] exited 0 in {seconds:.2f} s of wall time (child "
          f"process): {fit and fit.group(1)} feature rows from "
          f"{fit and fit.group(2)} images (train {fit and fit.group(3)}, "
          f"valid {fit and fit.group(4)}), GBM fit {fit and fit.group(5)} s "
          f"(host clock), best_iteration {fit and fit.group(6)} of "
          f"{fit and fit.group(7)} trees; CCL launches {got} on {smi}")
    if not fit or int(fit.group(1)) < 1 or int(fit.group(2)) != min(
            SCORING_SAMPLE, PREP_TRAIN + 2) or not model_file.exists() \
            or min(got.values()) < 1:
        raise AssertionError("scoring model training: "
                             + log.read_text()[-3000:])

    # (b) evaluate every pipeline of items 14 and 15, in this process
    for pipeline, layers in SCORING_EVALS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        manager = cli.main(["--config", config(pipeline, layers), "evaluate",
                            "-p", pipeline])
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        count(got)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_prediction(experiment / "prediction.json",
                         set(range(1, PREP_VAL + 1)), pipeline)
        ap, ar = last_scores(experiment)
        t = manager.timings
        scored = (f", scoring (tables + GBM) {t['scoring_s']:.4f} s, NMS "
                  f"{t['nms_s']:.4f} s, {t['suppressed']} instances "
                  f"suppressed" if "nms_s" in t else "")
        print(f"scoring: (b) `evaluate -p {pipeline}` with category_layers "
              f"{layers}: {t['images']} images in {t['total_s']:.4f} s, "
              f"{t['images'] / t['total_s']:.2f} images/s; decode "
              f"{t['decode_s']:.4f} s, device {t['device_s']:.4f} s, "
              f"annotation + RLE {t['annotation_s']:.4f} s, COCOeval "
              f"{t['cocoeval_s']:.4f} s{scored} (host clock); AP {ap} AR "
              f"{ar}; CCL launches {got}; peak device memory {peak:.2f} GiB")
        if t["images"] != PREP_VAL or min(got.values()) < 1:
            raise AssertionError(f"{pipeline}: {t['images']} images, "
                                 f"launches {got}")

    # (c) kernel path = plain path, 19 layers with the feature tensor
    paths = sorted((PREP_DIR / "data" / "val" / "images").iterdir())[:BATCH]
    tiles = np.stack([load_image(p) for p in paths])
    pipe = PIPELINES["unet_weighted"]["inference"](build_config(
        config("probe", [1, 19])))
    pipe._ensure_weights()
    probs = resize_bilinear(probs_of(pipe, tiles), (TILE, TILE))
    post = dict(target_size=(TILE, TILE), category_layers=(1, 19),
                active_layers=tuple(range(1, 20)), compute_features=True)
    kernel = postprocess.fused_postprocess(probs, **post)
    saved = postprocess.connected_components
    postprocess.connected_components = lambda mask: _renumber(
        _label_raw(mask != 0, mask.shape[-2] + mask.shape[-1]))
    try:
        plain = postprocess.fused_postprocess(probs, **post)
    finally:
        postprocess.connected_components = saved
    if not (torch.equal(kernel[0], plain[0]) and torch.equal(kernel[2],
                                                             plain[2])
            and torch.equal(kernel[3], plain[3])
            and torch.allclose(kernel[1], plain[1], rtol=1e-6, atol=0)):
        raise AssertionError("19-layer postprocess with features: kernel "
                             "path differs from the plain path")
    print(f"scoring: (c) 19-layer postprocess with the feature tensor, "
          f"kernel path = plain path on one batch ({int(kernel[0].amax())} "
          f"instances max; labels, areas and features exact, scores 1e-6 "
          f"relative)")

    # (e) K1 and `label` on those 380 masks
    thresholds = torch.tensor([t for t, _ in
                               postprocess.layer_thresholds((1, 19))[1:]],
                              device=DEVICE).view(1, -1, 1, 1)
    masks = (probs[..., 1][:, None] > thresholds).reshape(-1, TILE, TILE)
    ccl_times(masks, "scoring masks", old_kernels())
    n = masks.shape[0]
    print(f"scoring: bounds at ({n}, {TILE}, {TILE}) (kernels/bounds.py): "
          f"K1 {bounds.ccl_label_raw(n, TILE, TILE)}, label "
          f"{bounds.ccl_label(n, TILE, TILE)}")

    # (d) float32: the deduplicated TTA serve = the full 16-spec stack
    pipe32 = PIPELINES["unet_tta"]["inference"](build_config(config(
        "tta32", [1, 1], model_dtype="float32")))
    pipe32._ensure_weights()
    images = pipe32.loader.infer_preprocess(tiles)
    with torch.inference_mode():
        served = pipe32.serve_program()._probs(images)
        full = tta_wrap_predict(pipe32.trainer.probs_apply_fn(), tta_specs(),
                                pipe32.config.tta_aggregator.method,
                                dedupe=False)(images)
    err = float((served - full).abs().max())
    print(f"scoring: (d) float32 TTA of one batch, the served 12 "
          f"deduplicated forwards vs the 16-spec stack: max |diff| "
          f"{err:.3e} (tolerance 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("deduplicated TTA differs from the full stack")
    return launches


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_json(url, body=None, headers=None, timeout=120):
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def start_serve(args, log):
    """A SERVE_CHILD of the CLI arguments `args`, its output in `log`."""
    out = open(log, "w")
    try:
        return subprocess.Popen([sys.executable, "-c", SERVE_CHILD, *args],
                                cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
    finally:
        out.close()


def wait_healthy(proc, port, log):
    """/v1/health of a serve child, polled until SERVE_DEADLINE."""
    import urllib.error

    deadline = time.monotonic() + SERVE_DEADLINE
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"serve child exited {proc.returncode}:\n"
                                 + log.read_text()[-3000:])
        try:
            return http_json(f"http://127.0.0.1:{port}/v1/health",
                             timeout=5)
        except (urllib.error.URLError, OSError):
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"no /v1/health in {SERVE_DEADLINE} s")
        time.sleep(0.25)


def stop_serve(proc, log):
    """SIGTERM, then a kill at a 60 s deadline; returns the CCL and JPEG
    launch counts the child printed."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("a serve child ignored SIGTERM for 60 s")
    lines = [l for l in log.read_text().splitlines()
             if l.startswith("ccl launches ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"serve child exited {proc.returncode}:\n"
                             + log.read_text()[-3000:])
    return json.loads(lines[-1][len("ccl launches "):])


def drive_daemon(port, bodies, ids, concurrency, content_type):
    """POST every body to /v1/predict from `concurrency` client threads:
    (annotations per body, requests/s, p50 and p99 ms of the client's
    latency, the daemon's mean batch occupancy over the run)."""
    url = f"http://127.0.0.1:{port}"
    before = http_json(url + "/v1/stats")

    def post(i):
        start = time.perf_counter()
        got = http_json(url + "/v1/predict", bodies[i], {
            "Content-Type": content_type, "X-Image-Id": str(ids[i])})
        return got["annotations"], time.perf_counter() - start

    start = time.perf_counter()
    with ThreadPoolExecutor(concurrency) as pool:
        results = list(pool.map(post, range(len(bodies))))
    wall = time.perf_counter() - start
    after = http_json(url + "/v1/stats")
    latency = np.asarray([t for _, t in results]) * 1e3
    occupancy = ((after["requests"] - before["requests"])
                 / max(after["batches"] - before["batches"], 1))
    return ([a for a, _ in results], len(bodies) / wall,
            float(np.percentile(latency, 50)),
            float(np.percentile(latency, 99)), occupancy)


def by_batch_shape(run, tiles, buckets):
    """{bucket: [run's result per tile]}: each tile in batches of exactly
    `bucket` tiles (the tail padded with the last tile); run(batch) ->
    a list of per-tile results."""
    out = {}
    for b in buckets:
        results = []
        for start in range(0, len(tiles), b):
            idx = np.minimum(np.arange(start, start + b), len(tiles) - 1)
            results.extend(run(tiles[idx])[:min(b, len(tiles) - start)])
        out[b] = results
    return out


def annotate(outs, ids):
    """COCO annotations of each image of a collected batch, as the daemon
    converts them."""
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.infer.annotations import labeled_to_annotations

    return [labeled_to_annotations(i, outs[0][k], outs[1][k], CATEGORY_IDS,
                                   [1, 1]) for k, i in enumerate(ids)]


def same_annotations(got, want):
    return len(got) == len(want) and all(
        g["segmentation"] == w["segmentation"] and g["bbox"] == w["bbox"]
        and g["image_id"] == w["image_id"]
        and g["category_id"] == w["category_id"]
        and abs(g["score"] - w["score"]) <= 1e-5 * abs(w["score"])
        for g, w in zip(got, want))


def near_threshold_difference(got, want, prob, band):
    """Pixels where the foregrounds of two annotation lists differ, after
    checking that each such pixel has a probability `prob` within `band`
    of the 0.5 threshold, that every instance of one side that the other
    lacks touches such a pixel, and that instances on both sides have
    scores within band * sqrt(area); raises otherwise."""
    from mapping_tpu_torch.ops.rle import decode

    def instances(anns):
        return {a["segmentation"]["counts"]: (decode(a["segmentation"])
                                              .astype(bool), a["score"])
                for a in anns}

    near = np.abs(prob - 0.5) <= band
    inst_g, inst_w = instances(got), instances(want)
    fg = [np.zeros(prob.shape, bool), np.zeros(prob.shape, bool)]
    for side, inst in zip(fg, (inst_g, inst_w)):
        for mask, _ in inst.values():
            side |= mask
    differ = fg[0] != fg[1]
    away = differ & ~near
    if away.any():
        raise AssertionError(
            f"{int(differ.sum())} pixels differ, {int(away.sum())} of them "
            f"farther than {band:.3g} from the threshold (the nearest at "
            f"{float(np.abs(prob - 0.5)[away].min()):.3g})")
    touching = near.copy()
    touching[1:] |= near[:-1]
    touching[:-1] |= near[1:]
    touching[:, 1:] |= near[:, :-1]
    touching[:, :-1] |= near[:, 1:]
    for key in set(inst_g) ^ set(inst_w):
        mask, _ = inst_g.get(key, inst_w.get(key))
        if not (mask & touching).any():
            raise AssertionError("an instance differs away from the "
                                 "threshold")
    for key in set(inst_g) & set(inst_w):
        (mask, a), (_, b) = inst_g[key], inst_w[key]
        if abs(a - b) > band * math.sqrt(mask.sum()) + 1e-6 * abs(b):
            raise AssertionError(f"a score differs by {abs(a - b):.3g}")
    return int(differ.sum())


def serving_phase(smi, prepared):
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.loader import load_image
    from mapping_tpu_torch.infer.artifact import load_artifact
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import connected_components
    from mapping_tpu_torch.pipelines import PIPELINES
    from mapping_tpu_torch.tools.kernel_variants import (kernel_events,
                                                          short_name)
    from mapping_tpu_torch.utils import jpeg, native_decode

    phase_start = time.perf_counter()
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    experiment = SERVE_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    # phase 9 (a)'s weights and phase 10 (a)'s scoring model
    for name in ("unet.pt", "scoring_model.pkl"):
        shutil.copy2(SCORING_DIR / "experiment" / "transformers" / name,
                     experiment / "transformers" / name)
    launches = {k: 0 for k in K.LAUNCHES}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    def config(name, layers, **extra):
        return write_config(name, {
            "data_dir": str(PREP_DIR / "data"),
            "meta_dir": str(prepared["meta_dir"]),
            "experiment_dir": str(experiment), "device": DEVICE,
            "evaluation_data_sample": PREP_VAL, "category_layers": layers,
            "serve_batch_buckets": SERVE_BUCKETS, **SERVE_PARAMS, **extra},
            SERVE_DIR)

    weighted = config("weighted", [1, 1])
    scoring = config("scoring", [1, 19], serve_batch_buckets="")
    artifacts = {"unet_weighted": SERVE_DIR / "artifact",
                 "unet_scoring_model": SERVE_DIR / "artifact_scoring"}

    # (a) export, from the CLI in a child process
    log = SERVE_DIR / "export.log"
    rc, seconds, _ = run_child(
        [sys.executable, "-c", CLI_CHILDREN] + [json.dumps(
            ["--config", cfg, "export", "-p", pipeline, "--dir_path",
             str(artifacts[pipeline])])
            for cfg, pipeline in ((weighted, "unet_weighted"),
                                  (scoring, "unet_scoring_model"))], log)
    text = log.read_text()
    if rc != 0 or not text.strip().splitlines()[-1].startswith(
            "ccl launches "):
        raise AssertionError("export: " + text[-3000:])
    exports = re.findall(r"exported \S+/(artifact\w*)/serve_b(\d+)\.pt2 "
                         r"\([^)]*\) in ([\d.]+) s, ([\d.]+) MiB", text)
    sizes = {p: sum(f.stat().st_size for f in d.iterdir()) / 2 ** 20
             for p, d in artifacts.items()}
    print(f"serving: (a) `export -p unet_weighted` (buckets "
          f"{SERVE_BUCKETS} + 20) and `export -p unet_scoring_model` "
          f"(bucket 20) exited 0 in {seconds:.2f} s of wall time (one child "
          f"process): " + ", ".join(f"{d} b{b} {t} s {m} MiB"
                                    for d, b, t, m in exports)
          + "; artifact sizes " + ", ".join(f"{p} {m:.1f} MiB"
                                            for p, m in sizes.items())
          + f" on {smi}")
    if len(exports) != 4:
        raise AssertionError("export: " + text[-3000:])

    # (b) evaluate --artifact beside the live evaluate, in this process
    ids = set(range(1, PREP_VAL + 1))
    for pipeline, cfg in (("unet_weighted", weighted),
                          ("unet_scoring_model", scoring)):
        for what, argv in (("--artifact", ["--artifact",
                                           str(artifacts[pipeline])]),
                           ("live", ["-p", pipeline])):
            torch.cuda.synchronize()
            K.reset_launches()
            manager = cli.main(["--config", cfg, "evaluate", *argv])
            torch.cuda.synchronize()
            got = dict(K.LAUNCHES)
            count(got)
            check_prediction(experiment / "prediction.json", ids,
                             f"{pipeline} {what}")
            ap, ar = last_scores(experiment)
            t = manager.timings
            print(f"serving: (b) `evaluate {' '.join(argv)}` ({pipeline}): "
                  f"{t['images']} images in {t['total_s']:.4f} s, "
                  f"{t['images'] / t['total_s']:.2f} images/s; "
                  + (f"artifact load {t['load_s']:.4f} s, " if "load_s" in t
                     else "")
                  + f"decode {t['decode_s']:.4f} s, device "
                  f"{t['device_s']:.4f} s, annotation + RLE "
                  f"{t['annotation_s']:.4f} s"
                  + (f", scoring {t['scoring_s']:.4f} s, NMS "
                     f"{t['nms_s']:.4f} s" if "nms_s" in t else "")
                  + f", COCOeval {t['cocoeval_s']:.4f} s (host clock); AP "
                  f"{ap} AR {ar}; CCL launches {got}")
            if t["images"] != PREP_VAL or min(got.values()) < 1:
                raise AssertionError(f"{pipeline} {what}: {t['images']} "
                                     f"images, launches {got}")

    # (c) one batch through the artifact and the live FusedServe
    paths = sorted((PREP_DIR / "data" / "val" / "images").iterdir())
    tiles = np.stack([load_image(p) for p in paths])
    batch = tiles[:BATCH]
    art = load_artifact(str(artifacts["unet_weighted"]))
    pipe = PIPELINES["unet_weighted"]["inference"](build_config(weighted))
    pipe._ensure_weights()
    live_serve = pipe.serve_program()
    images = pipe.loader.infer_preprocess(batch)
    with torch.inference_mode():
        live_probs = resize_bilinear(live_serve._probs(images),
                                     (TILE, TILE))[..., 1]
    live = live_serve(images)
    module = pipe.serve_module().eval()

    class ResizedProbs(torch.nn.Module):
        """The exported program's forward up to the probabilities the
        postprocess thresholds."""

        def __init__(self):
            super().__init__()
            self.program = module

        def forward(self, u8):
            return resize_bilinear(self.program.probs(
                self.program.preprocess(u8)), (TILE, TILE))[..., 1]

    u8 = torch.from_numpy(batch).to(DEVICE)
    with torch.no_grad():
        torch.export.save(torch.export.export(ResizedProbs(), (u8,)),
                          str(SERVE_DIR / "probs.pt2"))
        replay_probs = torch.export.load(
            str(SERVE_DIR / "probs.pt2")).module()(u8)
    band = float((replay_probs - live_probs).abs().max())
    torch.cuda.synchronize()
    K.reset_launches()
    steps = []
    for _ in range(2):
        got = art(batch)
        steps.append(K.LAUNCHES["ccl_label_raw"])
    count(dict(K.LAUNCHES))
    if steps != [1, 2] or K.LAUNCHES["ccl_renumber"] != 2:
        raise AssertionError(f"replays launched {steps}, {K.LAUNCHES}")
    K.reset_launches()
    events = [short_name(k) for k, _ in
              kernel_events(lambda: art.collect(art.dispatch(batch)))]
    count(dict(K.LAUNCHES))
    missing = [k for k in CCL_KERNELS if not any(k in e for e in events)]
    if missing:
        raise AssertionError(f"the replay's trace lacks {missing}: {events}")
    near = (live_probs - 0.5).abs().cpu().numpy() <= band
    exact, flipped = 0, 0
    for i in range(BATCH):
        differ = (got[0][i, 1] > 0) != (live[0][i, 1] > 0)
        if (differ & ~near[i]).any():
            raise AssertionError(f"image {i}: the replay's labels differ "
                                 f"from the live serve away from the "
                                 f"threshold (band {band:.3g})")
        flipped += int(differ.sum())
        if not differ.any():
            if not (np.array_equal(got[0][i], live[0][i])
                    and np.array_equal(got[2][i], live[2][i])):
                raise AssertionError(f"image {i}: same foreground, other "
                                     f"labels or areas")
            exact += 1
    plain = connected_components(torch.from_numpy(got[0][:, 1] > 0))
    if not np.array_equal(plain.numpy(), got[0][:, 1]):
        raise AssertionError("the replay's labels differ from the plain CCL "
                             "on the CPU of the same masks")
    print(f"serving: (c) one batch of {BATCH} through the artifact and the "
          f"live FusedServe: max |replay - live| probability {band:.3e}; "
          f"{exact} of {BATCH} images with equal labels and areas, "
          f"{flipped} pixels on the other side of the threshold, all within "
          f"that band of it; the replay's labels = the plain CCL on the CPU "
          f"of its masks; CCL launches per replay {steps}; the replay's "
          f"{len(events)} kernels under the profiler include "
          f"{[e for e in events if any(k in e for k in CCL_KERNELS)]}")

    # (d) the serve children: a pipeline and the artifact, on the val
    # tiles as PNG and as JPEG bodies (written by the port's encoder; a
    # JPEG's pixel stage runs on the card and its tile stays there for the
    # batcher). A daemon's answer comes from a batch of one of the bucket
    # shapes, composed as the requests arrived: it must equal that tile's
    # answer from a batch of that shape here, or differ from the batch-20
    # one only where the probability lies within the largest difference
    # between the batch shapes' probabilities of the threshold
    image_ids = list(range(1, len(paths) + 1))
    buckets = art.manifest["batch_buckets"]
    top = buckets[-1]

    def probs_at(b):
        with torch.inference_mode():
            p = resize_bilinear(live_serve._probs(
                pipe.loader.infer_preprocess(b)), (TILE, TILE))[..., 1]
        return list(p.float().cpu().numpy())

    def references(tiles):
        """(each serve's answers at each batch shape, the probabilities at
        each shape, the band) of `tiles`."""
        refs = {"pipeline": by_batch_shape(
                    lambda b: annotate(live_serve(
                        pipe.loader.infer_preprocess(b)), [0] * len(b)),
                    tiles, buckets),
                "artifact": by_batch_shape(
                    lambda b: annotate(art.collect(art.dispatch(b)),
                                       [0] * len(b)), tiles, buckets)}
        for per_shape in refs.values():
            for anns in per_shape.values():
                for i, image_anns in enumerate(anns):
                    for a in image_anns:
                        a["image_id"] = image_ids[i]
        probs = by_batch_shape(probs_at, tiles, buckets)
        band = max(float(np.abs(np.stack(probs[b])
                                - np.stack(probs[top])).max())
                   for b in buckets)
        return refs, probs, band

    jpeg_bodies = [jpeg.encode(t, quality=95, sampling="4:2:0")
                   for t in tiles]
    jpeg_tiles = native_decode.assemble(
        [native_decode.read_bytes(b) for b in jpeg_bodies], "cpu").numpy()
    kinds = {"PNG": ([p.read_bytes() for p in paths], "image/png",
                     references(tiles)),
             "JPEG": (jpeg_bodies, "image/jpeg", references(jpeg_tiles))}
    for kind, (_, _, (_, _, band)) in kinds.items():
        print(f"serving: (d) max |probability| difference between batch "
              f"shapes {buckets} on the {len(tiles)} val tiles as {kind}: "
              f"{band:.3e}")

    def check(kind, name, i, answer, shapes=buckets):
        """(the first of `shapes` whose answer it equals, or None, and the
        pixels excused near the threshold)."""
        refs, probs, band = kinds[kind][2]
        for b in shapes:
            if same_annotations(answer, refs[name][b][i]):
                return b, 0
        try:
            return None, near_threshold_difference(
                answer, refs[name][top][i], probs[top][i], band)
        except AssertionError as e:
            raise AssertionError(f"serve {name}: {kind} image "
                                 f"{image_ids[i]}: {e}")

    children, decoded = {}, {}
    try:
        for name, args in (("pipeline", ["-p", "unet_weighted"]),
                           ("artifact", ["--artifact",
                                         str(artifacts["unet_weighted"])])):
            port = free_port()
            log = SERVE_DIR / f"serve_{name}.log"
            children[name] = (start_serve(
                ["--config", weighted, "serve", *args, "--port", str(port)],
                log), port, log)
        for name, (proc, port, log) in children.items():
            start = time.perf_counter()
            health = wait_healthy(proc, port, log)
            print(f"serving: (d) `serve` over the {name} answered /v1/health "
                  f"after {time.perf_counter() - start:.2f} s more: {health}")
            for kind, (bodies, content_type, _) in kinds.items():
                for concurrency in SERVE_CONCURRENCY:
                    answers, rps, p50, p99, occupancy = drive_daemon(
                        port, bodies, image_ids, concurrency, content_type)
                    matched = {b: 0 for b in buckets + [None]}
                    pixels = 0
                    for i, answer in enumerate(answers):
                        b, n = check(kind, name, i, answer)
                        matched[b] += 1
                        pixels += n
                    print(f"serving: (d) serve {name}, concurrency "
                          f"{concurrency}: {len(bodies)} {kind} requests, "
                          f"{rps:.2f} requests/s, latency p50 {p50:.2f} ms "
                          f"p99 {p99:.2f} ms (client clock), mean batch "
                          f"occupancy {occupancy:.2f}; answers equal to the "
                          f"one at batch shape {matched} (None: {pixels} "
                          f"pixels on the other side of the threshold, all "
                          f"within the band) on {smi}")
            start = time.perf_counter()
            answer = http_json(f"http://127.0.0.1:{port}/v1/predict",
                               kinds["PNG"][0][0],
                               {"Content-Type": "image/png",
                                "X-Image-Id": "1"})["annotations"]
            lone = (time.perf_counter() - start) * 1e3
            lone_shape = check("PNG", name, 0, answer)
            stats = http_json(f"http://127.0.0.1:{port}/v1/stats")
            print(f"serving: (d) serve {name}: a lone request in "
                  f"{lone:.2f} ms (batch shape / excused pixels "
                  f"{lone_shape}); /v1/stats {stats}")
        # predict_on_dir's answers are the batch-20 references
        prediction = SERVE_DIR / "predict_on_dir.json"
        cli.main(["--config", weighted, "predict_on_dir", "-p",
                  "unet_weighted", "--dir_path",
                  str(PREP_DIR / "data" / "val" / "images"),
                  "--prediction_path", str(prediction)])
        got_dir = [[] for _ in image_ids]
        for a in json.loads(prediction.read_text()):
            got_dir[a["image_id"]].append({**a, "image_id":
                                           a["image_id"] + 1})
        shapes = [check("PNG", "pipeline", i, anns, [top])[0]
                  for i, anns in enumerate(got_dir)]
        print(f"serving: (d) predict_on_dir: {shapes.count(top)} of "
              f"{len(shapes)} images equal to the batch-{top} answers, the "
              f"rest within the band")
    finally:
        for name, (proc, port, log) in children.items():
            if proc.poll() is None:
                try:
                    got = stop_serve(proc, log)
                except AssertionError:
                    raise
                count(got)
                decoded[name] = {k: got[k] for k in JPEG_KERNELS}
                print(f"serving: (d) serve {name} stopped; its CCL and JPEG "
                      f"launches {got}")
    for name, got in decoded.items():
        if not all(got.values()):
            raise AssertionError(f"serve {name} decoded the JPEG bodies "
                                 f"without jpeg_pixels: {got}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    print(f"serving: phase 11 took {time.perf_counter() - phase_start:.2f} s "
          f"(host clock)")
    return launches

def zoo_phase(smi, prepared):
    import contextlib
    import io

    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.loader import (in_memory_train_flow,
                                               load_image, load_target)
    from mapping_tpu_torch.data.metadata import read_metadata, write_metadata
    from mapping_tpu_torch.infer.artifact import export_serving_artifact
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.models.registry import build_network
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.pipelines import PIPELINES
    from mapping_tpu_torch.train.step import MULTI_HEAD
    from mapping_tpu_torch.train.trainer import UNetTrainer
    from mapping_tpu_torch.utils.png import read_png_rgb

    phase_start = time.perf_counter()
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    meta = ZOO_DIR / "meta"
    meta.mkdir(parents=True)
    # phase 9's metadata of phase 6's split: the first ZOO_TRAIN train
    # rows (the crowded and the empty tile among them) and every val row
    rows = read_metadata(Path(prepared["meta_dir"]) / "metadata.csv")
    train_rows = [r for r in rows if r["is_train"] == 1][:ZOO_TRAIN]
    val_rows = [r for r in rows if r["is_valid"] == 1]
    write_metadata(train_rows + val_rows, str(meta / "metadata.csv"))
    ids = set(range(1, PREP_VAL + 1))
    steps = -(-ZOO_TRAIN // BATCH)
    launches = {k: 0 for k in K.LAUNCHES}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    def config(name, **extra):
        return write_config(name, {
            "data_dir": str(PREP_DIR / "data"), "meta_dir": str(meta),
            "experiment_dir": str(ZOO_DIR / name), "device": DEVICE,
            **ZOO_PARAMS, **extra}, ZOO_DIR)

    # (a) each family: train 1 epoch and evaluate, one after another in
    # one child process
    paths = [r["file_path_image"] for r in val_rows[:BATCH]]
    tiles = np.stack([load_image(p) for p in paths])
    scores = {}
    configs = {family: config(family, encoder=family)
               for family in ZOO_FAMILIES}
    log = ZOO_DIR / "families.log"
    rc, seconds, rss = run_child(
        [sys.executable, "-c", ZOO_CHILD, *configs.values()], log)
    text = log.read_text()
    outs = [json.loads(line[len("zoo "):]) for line in text.splitlines()
            if line.startswith("zoo {")]
    if rc != 0 or len(outs) != len(ZOO_FAMILIES):
        raise AssertionError(f"the zoo child exited {rc}:\n" + text[-3000:])
    print(f"zoo: (a) the {len(ZOO_FAMILIES)} families' child: {seconds:.2f} "
          f"s, peak RSS {rss:.0f} MiB")
    # each family's part of the child's log: from its train to the next
    parts = re.split(r"(?m)^zoo \{.*$", text)
    for family, child, part in zip(ZOO_FAMILIES, outs, parts):
        cfg = configs[family]
        experiment = ZOO_DIR / family
        count(child["launches"])
        took = [float(t) for t in re.findall(r"epoch \d+ took ([\d.]+)s",
                                             part)]
        maps = re.findall(r"epoch \d+ validation mAP = ([\d.]+) in "
                          r"([\d.]+) s", part)
        check_prediction(experiment / "prediction.json", ids,
                         f"zoo {family}", allow_empty=True)
        ap, ar = last_scores(experiment)
        scores[family] = (ap, ar)
        mp = build_config(cfg).unet["model_params"]
        n_params = sum(p.numel() for p in build_network(mp).parameters())
        t = child["timings"]
        print(f"zoo: (a) {family}: {n_params:,} parameters; `train -p "
              f"unet_weighted` 1 epoch of {steps} steps of {BATCH} tiles "
              f"({ZOO_TRAIN} train tiles read from files) "
              + ", ".join(f"{1e3 * x / steps:.2f} ms/step" for x in took)
              + " (first epoch: cuDNN's first calls included), validation "
              f"mAP {maps[0][0] if maps else None} in "
              f"{maps[0][1] if maps else None} s on {PREP_VAL} tiles, peak "
              f"device memory {child['train_peak_mib']:.1f} MiB; `evaluate` "
              f"{t['images']} images in {t['total_s']:.4f} s, "
              f"{t['images'] / t['total_s']:.2f} images/s: decode "
              f"{t['decode_s']:.4f} s, device {t['device_s']:.4f} s, "
              f"annotation + RLE {t['annotation_s']:.4f} s, COCOeval "
              f"{t['cocoeval_s']:.4f} s (host clock), peak device memory "
              f"{child['evaluate_peak_mib']:.1f} MiB; AP {ap} AR {ar}; "
              f"{child['seconds']:.2f} s in the child, which held "
              f"{child['start_mib']:.1f} MiB of device memory at the "
              f"family's start (earlier families' leftovers, in the peaks "
              f"above); CCL launches train "
              f"{child['train_launches']}, train + evaluate "
              f"{child['launches']} on {smi}")
        if len(took) != 1 or len(maps) != 1 or t["images"] != PREP_VAL \
                or min(child["train_launches"].values()) < 1 \
                or min(child["launches"].values()) \
                <= min(child["train_launches"].values()):
            raise AssertionError(f"{family}: epochs {took}, mAP {maps}, "
                                 f"timings {t}, launches {child}")
        # the family's served masks: the CUDA label = the plain CCL
        pipe = PIPELINES["unet_weighted"]["inference"](build_config(cfg))
        pipe._ensure_weights()
        serve = pipe.serve_program()
        with torch.inference_mode():
            probs = resize_bilinear(serve._probs(
                pipe.loader.infer_preprocess(tiles)), (TILE, TILE))[..., 1]
        for what, masks in (("served", probs > 0.5),
                            ("at the median", probs > probs.median())):
            kernel, plain = K.label(masks), _renumber(_label_raw(masks,
                                                                 2 * TILE))
            if not torch.equal(kernel, plain):
                raise AssertionError(f"{family}: label != plain CCL on the "
                                     f"{what} masks")
            print(f"zoo: (a) {family}: CUDA label = plain CCL on the {what} "
                  f"masks of {BATCH} val tiles ({int(plain.amax())} "
                  f"components max per image)")
        del pipe, serve, probs

    # (b) the multi-head model trains, and refuses validation and serving
    rows20 = train_rows[:BATCH]
    images_u8 = np.stack([load_image(r["file_path_image"]) for r in rows20])
    targets = np.stack([load_target(r["file_path_mask_eroded_0_dilated_0"])
                        for r in rows20])

    def flow():
        return in_memory_train_flow(images_u8, targets, BATCH, TRAIN_SIZE,
                                    torch.Generator().manual_seed(0),
                                    device=DEVICE)

    multi_cfg = build_config(config("multitask", encoder="from_scratch",
                                    nr_unet_outputs=2))
    unet = multi_cfg.unet
    trainer = UNetTrainer(
        unet["model_params"], unet["optimizer_params"], unet["loss"],
        {"epochs": ZOO_MULTI_STEPS}, loss_name="weighted",
        input_size=TRAIN_SIZE, device=DEVICE)
    start = time.perf_counter()
    trainer.fit(flow())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    losses = trainer.train_losses
    refused = []
    for what, call in (
            ("validation", lambda: trainer.score_validation(flow())),
            ("serving", trainer.probs_apply_fn),
            ("export", lambda: export_serving_artifact(
                PIPELINES["unet_weighted"]["inference"](multi_cfg)
                .set_weights(trainer.state_dict()), multi_cfg,
                str(ZOO_DIR / "multitask_artifact")))):
        try:
            call()
        except TypeError as err:
            if str(err) == MULTI_HEAD:
                refused.append(what)
    print(f"zoo: (b) UNetMultitask (nr_outputs 2): {len(losses)} train "
          f"steps in {seconds:.2f} s, losses {losses}; refused: {refused}")
    if len(losses) != ZOO_MULTI_STEPS or not np.isfinite(losses).all() \
            or refused != ["validation", "serving", "export"]:
        raise AssertionError("the multi-head leg did not train and refuse")
    del trainer

    # (c) VGG11's artifact: export, then evaluate --artifact = the live AP/AR
    vgg11 = config("VGG11", encoder="VGG11")
    artifact = ZOO_DIR / "VGG11_artifact"
    torch.cuda.synchronize()
    K.reset_launches()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the manifest
        cli.main(["--config", vgg11, "export", "-p", "unet_weighted",
                  "--dir_path", str(artifact)])
    export_s = time.perf_counter() - start
    manager = cli.main(["--config", vgg11, "evaluate", "--artifact",
                        str(artifact)])
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    count(got)
    check_prediction(ZOO_DIR / "VGG11" / "prediction.json", ids,
                     "zoo VGG11 --artifact", allow_empty=True)
    art_scores = last_scores(ZOO_DIR / "VGG11")
    t = manager.timings
    print(f"zoo: (c) VGG11 `export` in {export_s:.2f} s ("
          f"{sum(f.stat().st_size for f in artifact.iterdir()) / 2 ** 20:.1f}"
          f" MiB), `evaluate --artifact` {t['images'] / t['total_s']:.2f} "
          f"images/s (load {t['load_s']:.4f} s): AP/AR {art_scores} against "
          f"the live {scores['VGG11']}; CCL launches {got}")
    if art_scores != scores["VGG11"] or min(got.values()) < 1:
        raise AssertionError("the VGG11 artifact's AP/AR differ from the "
                             "live evaluate's")

    # (d) visualize VGG16's prediction.json; the parity drill on its weights
    vgg16 = config("VGG16", encoder="VGG16")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--config", vgg16, "visualize", "--prediction_path",
                  str(ZOO_DIR / "VGG16" / "prediction.json"), "--out_dir",
                  str(ZOO_DIR / "overlays"), "-n", "4"])
    written = json.loads(out.getvalue().strip().splitlines()[-1])["written"]
    shapes = {read_png_rgb(p).shape for p in written}
    print(f"zoo: (d) `visualize` of VGG16's prediction.json wrote "
          f"{len(written)} overlays {sorted(Path(p).name for p in written)} "
          f"of shapes {shapes}")
    if len(written) != 4 or shapes != {(TILE, TILE, 3)}:
        raise AssertionError(f"visualize wrote {written}")
    reference = ZOO_DIR / "vgg16_reference.pth"
    state = torch.load(ZOO_DIR / "VGG16" / "transformers" / "unet.pt",
                       map_location="cpu", weights_only=True)
    torch.save({"module." + k: v for k, v in state.items()}, reference)
    drill = write_config("drill", {
        "meta_dir": str(ZOO_DIR / "drill_meta"),
        "experiment_dir": str(ZOO_DIR / "drill"), "device": DEVICE,
        "encoder": "VGG16", **ZOO_PARAMS}, ZOO_DIR)
    torch.cuda.synchronize()
    K.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--config", drill, "parity_drill", "-p", "unet_weighted",
                  "--checkpoint", str(reference), "--data_dir",
                  str(PREP_DIR / "data")])
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    count(got)
    text = out.getvalue()
    report = json.loads(text[text.index("{\n"):])
    print(f"zoo: (d) `parity_drill` on VGG16's weights (a module.-prefixed "
          f".pth): {json.dumps(report)}; CCL launches {got}")
    if (report["ap"], report["ar"]) != scores["VGG16"] \
            or not (ZOO_DIR / "drill_meta" / "metadata.csv").exists() \
            or min(got.values()) < 1:
        raise AssertionError(f"the drill's AP/AR {report} differ from "
                             f"VGG16's evaluate {scores['VGG16']}")
    print(f"zoo: phase 12 took {time.perf_counter() - phase_start:.2f} s; "
          f"CCL launches {launches}")
    return launches


def int8_conv_cases():
    """Phase 13 (a): the six conv geometries of tests/test_quantize.py
    (CONV_VARIANTS) at c_in = c_out = QUANT_WIDTH, and the ResNet stem at
    c_in = 3: name -> (the port's module, NCHW input shape)."""
    from torch import nn

    c = QUANT_WIDTH
    return {
        "same3": (nn.Conv2d(c, c, 3, padding=1), (BATCH, c, 64, 64)),
        "strided": (nn.Conv2d(c, c, 3, stride=2, padding=1),
                    (BATCH, c, 64, 64)),
        "stem": (nn.Conv2d(c, c, 7, stride=2, padding=3), (BATCH, c, 64, 64)),
        "deconv_same": (nn.ConvTranspose2d(c, c, 4, stride=2, padding=1),
                        (BATCH, c, 32, 32)),
        "deconv_v1": (nn.ConvTranspose2d(c, c, 3, stride=2, padding=1,
                                         output_padding=1),
                      (BATCH, c, 32, 32)),
        "one_by_one": (nn.Conv2d(c, c, 1), (BATCH, c, 64, 64)),
        "stem c_in=3": (nn.Conv2d(3, 64, 7, stride=2, padding=3),
                        (BATCH, 3, 256, 256)),
    }


def quantize_phase(gen, smi, prepared):
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.loader import load_image
    from mapping_tpu_torch.kernels import bounds
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.models import quantize as Q
    from mapping_tpu_torch.ops.crf import dense_crf
    from mapping_tpu_torch.pipelines import PIPELINES

    phase_start = time.perf_counter()
    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    experiment = QUANT_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    # phase 9 (a)'s weights: random ones find no building
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    launches = {k: 0 for k in K.LAUNCHES}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    def config(name, **extra):
        return write_config(name, {
            "data_dir": str(PREP_DIR / "data"),
            "meta_dir": str(prepared["meta_dir"]),
            "experiment_dir": str(experiment), "device": DEVICE,
            "evaluation_data_sample": PREP_VAL, **QUANT_MODEL, **extra},
            QUANT_DIR)

    # (a) the int8 accumulator = a float64 conv of the same integers
    rows_a = []
    for name, (mod, shape) in int8_conv_cases().items():
        mod = mod.to(DEVICE)
        w = torch.randint(-127, 128, tuple(mod.weight.shape), generator=gen,
                          dtype=torch.int8).to(DEVICE)
        qx = torch.randint(-127, 128, shape, generator=gen,
                           dtype=torch.int8).to(DEVICE)
        port = Q.QuantizedConv(mod, {
            "w": w, "w_scale": torch.ones(w.shape[1 if isinstance(
                mod, torch.nn.ConvTranspose2d) else 0], device=DEVICE),
            "x_scale": torch.tensor(1.0, device=DEVICE)})
        nhwc = qx.permute(0, 2, 3, 1).contiguous()

        def run():
            return Q.int8_conv(nhwc, port.w_mat, port.kernel_size,
                               port.c_out, **port.geometry)

        acc = run()
        mod64 = mod.double()
        with torch.no_grad():
            mod64.weight.copy_(w.double())
            mod64.bias.zero_()
            want = mod64(qx.double())
        got = acc.permute(0, 3, 1, 2).double()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"int8 conv {name}: the int32 accumulator "
                                 f"differs from the float64 conv")
        modbf = mod.to(torch.bfloat16).to(memory_format=torch.channels_last)
        xbf = qx.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            times = in_turns({"int8": run, "bf16": lambda: modbf(xbf)},
                             {"int8": cuda_ms, "bf16": cuda_ms},
                             {"int8": 5, "bf16": 5})
        int8_ms, bf16_ms = min(times["int8"]), min(times["bf16"])
        k = port.w_mat.shape[1]
        bound = bounds.int8_conv(acc.shape[0] * acc.shape[1] * acc.shape[2],
                                 k, port.c_out, qx.numel())
        rows_a.append(name)
        print(f"quantize: (a) int8 conv {name} {tuple(shape)} -> "
              f"{tuple(got.shape)}: int32 accumulator = float64 conv, "
              f"exactly; {int8_ms:.4f} ms per call (im2col + _int_mm, "
              f"CUDA events, readings {times['int8']}), bf16 cuDNN conv "
              f"{bf16_ms:.4f} ms ({times['bf16']}), bound "
              f"{bound[0]:.4f} ms ({bound[1]}) on {smi}")
        del mod, mod64, modbf, acc, want, got
    torch.cuda.empty_cache()

    # (b) evaluate with quantized_serving: 1, the CLI in a child process
    quant = config("quantized", **QUANT_PARAMS)
    log = QUANT_DIR / "evaluate.log"
    rc, seconds, _ = run_child([sys.executable, "-c", QUANT_CHILD,
                                "--config", quant, "evaluate", "-p",
                                "unet_weighted"], log)
    text = log.read_text()
    last = text.strip().splitlines()[-1] if text.strip() else ""
    calib = re.search(r"quantized serving: (\d+) conv\(s\) int8, "
                      r"calibrated on (\d+) image\(s\) in ([\d.]+) s",
                      text)
    if rc != 0 or not last.startswith("quantized ") or not calib:
        raise AssertionError("quantized evaluate: " + text[-3000:])
    child = json.loads(last[len("quantized "):])
    count(child["launches"])
    prediction = check_prediction(experiment / "prediction.json",
                                  set(range(1, PREP_VAL + 1)),
                                  "quantized evaluate")
    live = QUANT_DIR / "live_prediction.json"
    shutil.copy2(experiment / "prediction.json", live)
    q_scores = last_scores(experiment)
    t, c = child["timings"], child["cold"]
    batches = -(-PREP_VAL // BATCH)
    print(f"quantize: (b) `evaluate -p unet_weighted` with "
          f"quantized_serving: 1, twice in one child process, exited 0 in "
          f"{seconds:.2f} s of wall time: the first run {c['images']} images "
          f"in {c['total_s']:.4f} s, {c['images'] / c['total_s']:.2f} "
          f"images/s, device {c['device_s']:.4f} s; the second "
          f"{t['images']} images in {t['total_s']:.4f} s, "
          f"{t['images'] / t['total_s']:.2f} images/s; calibration "
          f"{calib.group(3)} s on {calib.group(2)} images; {calib.group(1)} "
          f"convs int8 (the first run's log); the second run's _int_mm calls "
          f"{child['int_mm']} over {batches} batches, device "
          f"{t['device_s']:.4f} "
          f"s, decode {t['decode_s']:.4f} s, annotation + RLE "
          f"{t['annotation_s']:.4f} s, COCOeval {t['cocoeval_s']:.4f} s "
          f"(host clock); AP/AR {q_scores}; {len(prediction)} instances; "
          f"CCL launches {child['launches']}")
    if int(calib.group(1)) < 1 or child["int_mm"] < 1 \
            or min(child["launches"].values()) < 1:
        raise AssertionError(f"quantized evaluate ran no int8 conv or no "
                             f"CCL kernel: {child}")
    K.reset_launches()
    flt = cli.main(["--config", config("float"), "evaluate", "-p",
                    "unet_weighted"])
    torch.cuda.synchronize()
    count(dict(K.LAUNCHES))
    f_scores = last_scores(experiment)
    ft = flt.timings
    print(f"quantize: (b) the float evaluate of the same weights and tiles "
          f"(in process): {ft['images'] / ft['total_s']:.2f} images/s, "
          f"device {ft['device_s']:.4f} s, AP/AR {f_scores}; int8 - float "
          f"AP {q_scores[0] - f_scores[0]:+.4f}, AR "
          f"{q_scores[1] - f_scores[1]:+.4f}")

    # (b) in process: the int8 probabilities against the float ones
    pipe = PIPELINES["unet_weighted"]["inference"](build_config(quant))
    pipe._ensure_weights()
    start = time.perf_counter()
    probs_q = pipe._probs_fn()
    calib_s = time.perf_counter() - start
    paths = sorted((PREP_DIR / "data" / "val" / "images").iterdir())[:BATCH]
    tiles = np.stack([load_image(str(p)) for p in paths])
    images = pipe.loader.infer_preprocess(tiles)
    before = Q.MATMULS["int_mm"]
    got = probs_q(images)
    torch.cuda.synchronize()
    per_batch = Q.MATMULS["int_mm"] - before
    want = pipe.trainer.probs_apply_fn()(images)
    confident = (want[..., 1] - 0.5).abs() > 0.1
    agree = ((got[..., 1] > 0.5) == (want[..., 1] > 0.5))[confident]
    share = agree.float().mean().item()
    mean_dp = (got - want).abs().mean().item()
    qtable = probs_q.get_packed()["qtable"]
    print(f"quantize: (b) int8 against float probabilities on {BATCH} val "
          f"tiles: argmax agreement {share:.6f} on "
          f"{int(confident.sum())} confident pixels (|p - 0.5| > 0.1), mean "
          f"|dp| {mean_dp:.6f}; {len(qtable)} convs in the qtable; "
          f"{per_batch} _int_mm calls per batch of {BATCH}; calibration "
          f"{calib_s:.3f} s in process")
    if not share > QUANT_AGREEMENT or not int(confident.sum()) \
            or not len(qtable) or per_batch < 1:
        raise AssertionError(f"int8 serving agrees with float on {share} of "
                             f"the confident pixels")

    # (c) the exported int8 program: its evaluate = (b)'s, bit for bit
    artifact = QUANT_DIR / "artifact"
    export_cfg = config("export", serve_batch_buckets="", **QUANT_PARAMS)
    seconds, got_l = run_cli(export_cfg, QUANT_DIR / "export.log", "export",
                             "-p", "unet_weighted", "--dir_path",
                             str(artifact))
    count(got_l)
    manifest = json.loads((artifact / "manifest.json").read_text())
    K.reset_launches()
    replay = cli.main(["--config", quant, "evaluate", "--artifact",
                       str(artifact)])
    torch.cuda.synchronize()
    count(dict(K.LAUNCHES))
    same = json.loads((experiment / "prediction.json").read_text()) == \
        json.loads(live.read_text())
    rt = replay.timings
    print(f"quantize: (c) `export` of the int8 program (bucket "
          f"{manifest['batch_buckets']}, quantized {manifest['quantized']}) "
          f"in {seconds:.2f} s (child process), then `evaluate --artifact`: "
          f"{rt['images'] / rt['total_s']:.2f} images/s, load "
          f"{rt.get('load_s', 0):.4f} s, AP/AR {last_scores(experiment)}; "
          f"annotations bit-equal to (b)'s: {same}; CCL launches "
          f"{dict(K.LAUNCHES)}")
    if not same or manifest["quantized"] is not True:
        raise AssertionError("the int8 artifact's annotations differ from "
                             "the live int8 evaluate's")

    # (d) dense_crf on one 300^2 tile, the card against the CPU
    image = torch.from_numpy(tiles[0]).to(torch.float32) / 255.0
    probs = resize_bilinear(want[:1], (TILE, TILE))[0]
    for mode, kw in (("window", {}), ("grid", dict(
            iterations=3, sxy_bilateral=8.0, srgb=40.0,
            compat_bilateral=6.0))):
        on_card = dense_crf(image.to(DEVICE), probs, **kw)
        on_cpu = dense_crf(image, probs.cpu(), **kw)
        err = (on_card.cpu() - on_cpu).abs().max().item()
        card_ms = cuda_ms(lambda: dense_crf(image.to(DEVICE), probs, **kw),
                          3)
        start = time.perf_counter()
        dense_crf(image, probs.cpu(), **kw)
        cpu_ms = 1e3 * (time.perf_counter() - start)
        print(f"quantize: (d) dense_crf {mode} mode on a {TILE}^2 tile: "
              f"card vs CPU max |dq| {err:.3e} (tolerance {CRF_TOL}); card "
              f"{card_ms:.3f} ms (CUDA events), CPU {cpu_ms:.1f} ms (host "
              f"clock)")
        if not err <= CRF_TOL:
            raise AssertionError(f"dense_crf {mode}: card and CPU differ by "
                                 f"{err}")
    print(f"quantize: phase 13 took {time.perf_counter() - phase_start:.2f} "
          f"s; CCL launches {launches}")
    return launches


def rank_setup(setup):
    """A spawned rank runs this file anew: the phase's settings (DEVICE,
    TRAIN_SIZE, BATCH, DDP_MODEL, FIT_MODEL) as the parent has them."""
    globals().update(setup)


def step_outputs(state, batch, dtype, mesh=None):
    """One step of the default trainer with DDP_MODEL in `dtype` (bf16
    under autocast, float32 with TF32 off, or float64) on `batch` (a
    rank's shard on a mesh): (loss, gradients, BatchNorm running
    statistics), on the device."""
    if dtype == torch.bfloat16:
        t = trainer("bfloat16", state, mesh=mesh, model=DDP_MODEL)
    else:
        t = trainer("float32", state, mesh=mesh, model=DDP_MODEL)
        t.model.to(dtype)
        t.dtype = dtype
    t._ensure_state()
    inputs = torch.promote_types(dtype, torch.float32)
    loss = float(t._train_steps([{k: v.to(t.device, inputs)
                                  for k, v in batch.items()}], 0)
                 ["loss"][0])
    return (loss, {n: p.grad for n, p in t.model.named_parameters()},
            {k: v for k, v in t.model.state_dict().items()
             if "running" in k})


DDP_DTYPES = (("f32", torch.float32), ("f64", torch.float64),
              ("bf16", torch.bfloat16))


def rel_errors(got, want):
    """{name: max |got - want| / max |want|}."""
    return {n: float((got[n].to(w.device, w.dtype) - w).abs().max())
            / (float(w.abs().max()) or 1.0) for n, w in want.items()}


def l2_distance(got, want):
    """|got - want| / |want| over all tensors together (float64)."""
    num = sum(float((got[n].to(w.device, torch.float64)
                     - w.to(torch.float64)).square().sum())
              for n, w in want.items())
    den = sum(float(w.to(torch.float64).square().sum())
              for w in want.values())
    return math.sqrt(num / den)


def instances_agree(got, want, p_ref, band):
    """Phase 14 (a), two served outputs (labels, scores, areas) image by
    image: labels and areas equal and scores within 1e-4 relative, or
    labels that differ only at pixels whose probability p_ref lies within
    `band` of the threshold (the rule of tests/test_torch_evaluate.py's
    assert_same_instances). The number of images that differ; raises at a
    pixel beyond the band."""
    near = ((p_ref - 0.5).abs() <= band).cpu().numpy()
    differ = 0
    for i in range(len(got[0])):
        if np.array_equal(got[0][i], want[0][i]):
            w = min(got[1].shape[-1], want[1].shape[-1])
            np.testing.assert_array_equal(got[2][i][..., :w],
                                          want[2][i][..., :w])
            np.testing.assert_allclose(got[1][i][..., :w],
                                       want[1][i][..., :w], rtol=1e-4,
                                       atol=0)
            continue
        away = ((got[0][i, 1] > 0) != (want[0][i, 1] > 0)) & ~near[i]
        if away.any():
            raise AssertionError(f"parallel: (a) image {i}: labels differ at "
                                 f"{int(away.sum())} pixels farther than "
                                 f"{band:.3g} from the threshold")
        differ += 1
    return differ


def ddp_step_rank(setup, reference_path, batch_path):
    """Phase 14 (c) on a rank: one step of the default trainer on the
    group's mesh with this rank's shard of the global batch, in float32,
    float64 and bf16, held against the single-process steps saved at
    reference_path."""
    from mapping_tpu_torch.parallel import distributed
    from mapping_tpu_torch.parallel.mesh import make_mesh, shard_batch

    rank_setup(setup)
    ref = torch.load(reference_path, map_location="cpu", weights_only=True)
    batch = shard_batch(torch.load(batch_path, weights_only=True), make_mesh(
        ["cpu"] * distributed.world()))[distributed.rank()]
    out = {"rank": distributed.rank(),
           "backend": torch.distributed.get_backend()}
    for name, dtype in DDP_DTYPES:
        loss, grads, stats = step_outputs(ref["init"], batch, dtype, "auto")
        want = ref[name]
        errors = rel_errors(grads, want["grads"])
        worst = max(errors, key=errors.get)
        out[name] = {"loss": loss, "grad_err": errors[worst],
                     "worst": worst,
                     "stat_err": max(rel_errors(stats, want["stats"])
                                     .values())}
        if name != "f64":  # the whole gradient's relative L2 distances
            out[name]["l2"] = l2_distance(grads, want["grads"])
            out[name]["l2_f64"] = l2_distance(grads, ref["f64"]["grads"])
        del grads, stats
        torch.cuda.empty_cache()
    return out


def parallel_rank(setup, reference_path, batch_path, state_path, x, y,
                  checkpoint_dir):
    """Phase 14 (c), then (d) on a rank: the step held against one
    process, a fit of one epoch that writes last.pt, and a fresh trainer
    that resumes from it for a second epoch."""
    out = {"step": ddp_step_rank(setup, reference_path, batch_path)}
    torch.cuda.empty_cache()
    out["fit"] = fit_rank(setup, state_path, x, y, checkpoint_dir, 1)
    torch.distributed.barrier()  # last.pt written before it is read
    out["resumed"] = fit_rank(setup, state_path, x, y, checkpoint_dir, 2)
    return out


def fit_rank(setup, state_path, x, y, checkpoint_dir, epochs):
    """Phase 14 (d) on a rank: `epochs` of bf16 UNetTrainer.fit over the
    files x, y (FIT_STEPS global batches each) on the group's mesh with
    the resume callbacks in checkpoint_dir; each step's host seconds."""
    from mapping_tpu_torch.data.loader import SegmentationLoader
    from mapping_tpu_torch.parallel import distributed

    rank_setup(setup)
    t = trainer("bfloat16", torch.load(state_path, weights_only=True),
                model=FIT_MODEL,
                mesh="auto" if distributed.is_active() else None,
                training_config={"epochs": epochs, "steps_per_call": 1},
                callbacks_config={
                    "checkpoint_dir": str(checkpoint_dir), "resume": True,
                    "resume_every": 1, "best_write_every": 1,
                    "validate_with_map": False})
    dp = t.data_parallel
    loader = SegmentationLoader(size=TRAIN_SIZE, batch_size_train=BATCH,
                                device=t.device, shard=None if dp is None
                                else (dp.rank, dp.world))
    flow = loader.transform(x, y)["datagen"]
    t._ensure_state(steps_per_epoch=flow[1])
    steps, seconds = t._train_steps, []

    def timed(batches, first):
        start = time.perf_counter()
        out = steps(batches, first)
        out["loss"].tolist()  # the host reads each loss back
        seconds.append(time.perf_counter() - start)
        return out

    t._train_steps = timed
    t.fit(flow)
    return {"rank": distributed.rank(), "step": t.step,
            "next_epoch": t.resume_info.get("next_epoch", 0),
            "losses": t.train_losses, "seconds": seconds}


def parallel_phase(smi, prepared):
    """Phase 14: data parallel on the one card."""
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.loader import load_image, load_target
    from mapping_tpu_torch.data.loader import eval_batch_resize
    from mapping_tpu_torch.data.metadata import read_metadata
    from mapping_tpu_torch.data.tta import tta_specs
    from mapping_tpu_torch.infer.serving import FusedServe
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.parallel import distributed, make_mesh
    from mapping_tpu_torch.pipelines import PIPELINES

    phase_start = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    card = "cuda:0" if DEVICE == "cuda" else DEVICE
    setup = {"DEVICE": DEVICE, "TRAIN_SIZE": TRAIN_SIZE, "BATCH": BATCH,
             "DDP_MODEL": DDP_MODEL, "FIT_MODEL": FIT_MODEL}
    weights = TRAIN_DIR / "full" / "transformers" / "unet.pt"
    rows = read_metadata(prepared["meta_dir"] / "metadata.csv")
    train = [r for r in rows if r["is_train"] == 1]
    valid = [r for r in rows if r["is_valid"] == 1]
    launches = {k: 0 for k in K.LAUNCHES}

    def config(name, **extra):
        experiment = PARALLEL_DIR / name
        (experiment / "transformers").mkdir(parents=True)
        shutil.copy2(weights, experiment / "transformers" / "unet.pt")
        return write_config(name, {
            "data_dir": str(PREP_DIR / "data"),
            "meta_dir": str(prepared["meta_dir"]),
            "experiment_dir": str(experiment), "device": DEVICE,
            "evaluation_data_sample": PREP_VAL, **PARALLEL_PARAMS, **extra},
            PARALLEL_DIR)

    # (a) two replicas on the card against one, on the val tiles
    pipe = PIPELINES["unet_weighted"]["inference"](
        build_config(config("serving")))
    pipe._ensure_weights()
    mesh = make_mesh([card, card])
    flow, steps = pipe.loader.transform(
        [r["file_path_image"] for r in valid], None,
        train_mode=False)["datagen"]
    batches = [b["image"] for _, b in zip(range(steps), flow)]
    for tta in (False, True):
        args = pipe._serve_args(False)
        if tta:
            args["tta_specs"] = tta_specs()
        single = FusedServe(pipe._probs_fn(), **args)
        meshed = FusedServe(pipe._probs_fn(), mesh=mesh, **args)
        times, deltas, outs = {}, {}, {}
        for name, serve in (("single", single), ("mesh", meshed)):
            serve(batches[0])  # warm-up: cuDNN plans for this batch shape
            torch.cuda.synchronize()
            before = dict(K.LAUNCHES)
            start = time.perf_counter()
            outs[name] = [serve(b) for b in batches]
            torch.cuda.synchronize()
            times[name] = 1e3 * (time.perf_counter() - start) / len(batches)
            deltas[name] = K.LAUNCHES["ccl_label_raw"] - before[
                "ccl_label_raw"]
            for k in launches:
                launches[k] += K.LAUNCHES[k] - before[k]
        if deltas["mesh"] != 2 * deltas["single"] or not deltas["single"]:
            raise AssertionError(f"parallel: (a) CCL label launches "
                                 f"{deltas}: the mesh must label each of "
                                 f"its 2 shards once per batch")
        bands = {"shard": 0.0, "mesh": 0.0, "own": 0.0}
        differ = {"shard": 0, "mesh": 0, "own": 0}
        for b, got, want in zip(batches, outs["mesh"], outs["single"]):
            halves = b.chunk(2)
            h = len(halves[0])
            with torch.inference_mode():
                p_single, p_half, p_mesh = (torch.cat([resize_bilinear(
                    fn(part), (TILE, TILE))[..., 1] for part in parts])
                    for fn, parts in ((single._probs, [b]),
                                      (single._probs, halves),
                                      (meshed._probs, halves)))
            band = {"shard": float((p_mesh - p_half).abs().max()),
                    "mesh": float((p_mesh - p_single).abs().max()),
                    "own": float((p_half - p_single).abs().max())}
            for k in bands:
                bands[k] = max(bands[k], band[k])
            # the mesh against one device at the shard's batch, and both
            # against one device at BATCH
            halves_out = [single(part) for part in halves]
            for k, half in enumerate(halves_out):
                rows = slice(k * h, (k + 1) * h)
                differ["shard"] += instances_agree(
                    [o[rows] for o in got], half, p_half[rows],
                    band["shard"])
                differ["own"] += instances_agree(
                    half, [o[rows] for o in want], p_single[rows],
                    band["own"])
            differ["mesh"] += instances_agree(got, want, p_single,
                                              band["mesh"])
        print(f"parallel: (a) {'TTA ' if tta else ''}FusedServe over the "
              f"mesh {[str(d) for d in mesh.devices]} (two replicas on the "
              f"card) vs one device, {len(batches)} batches of {BATCH} of "
              f"the {len(valid)} val tiles, bf16. Against one device at "
              f"the shard's batch {BATCH // 2}: max |dp| {bands['shard']:.3g} "
              f"(tolerance {SHARD_BAND}), {differ['shard']} images with "
              f"other labels. Against one device at {BATCH}: max |dp| "
              f"{bands['mesh']:.3g} (tolerance min({BAND_MARGIN} x one "
              f"device's own batch {BATCH // 2}-vs-{BATCH} reading "
              f"{bands['own']:.3g}, {BAND_CEIL})), {differ['mesh']} images "
              f"with other labels, only within that band of the threshold "
              f"(one device's own: {differ['own']}; the others: labels and "
              f"areas equal, scores within 1e-4 relative); CCL label "
              f"launches {deltas} (one per shard per batch); ms per batch "
              f"(host clock, synchronised) one device "
              f"{times['single']:.2f}, mesh {times['mesh']:.2f} on {smi}")
        limit = min(max(BAND_MARGIN * bands["own"], SHARD_BAND), BAND_CEIL)
        if not (bands["shard"] <= SHARD_BAND and bands["mesh"] <= limit
                and differ["mesh"] <= differ["own"] + differ["shard"]):
            raise AssertionError(f"parallel: (a) the mesh's probabilities or "
                                 f"labels leave one device's: {bands}, "
                                 f"{differ}")
    del pipe, single, meshed, batches
    torch.cuda.empty_cache()

    # (b) data_parallel: 1 with one visible card is the plain path
    plain, dp_cfg = config("plain"), config("dp", data_parallel=1)
    for cfg in (plain, dp_cfg):
        before = dict(K.LAUNCHES)
        cli.main(["--config", cfg, "evaluate", "-p", "unet_weighted"])
        for k in launches:
            launches[k] += K.LAUNCHES[k] - before[k]
    same = (PARALLEL_DIR / "plain" / "prediction.json").read_bytes() == \
        (PARALLEL_DIR / "dp" / "prediction.json").read_bytes()
    print(f"parallel: (b) evaluate with data_parallel: 1 on "
          f"{torch.cuda.device_count() if DEVICE == 'cuda' else 1} card(s):"
          f" prediction.json byte-equal to the plain evaluate's: {same}; "
          f"AP/AR {last_scores(PARALLEL_DIR / 'dp')}")
    if not same:
        raise AssertionError("data_parallel: 1 on one card changed the "
                             "predictions")

    # (c) one step in float32 (TF32 off) and in float64: two gloo ranks
    # sharing the card, and one NCCL rank, each against the single-process
    # step on the same 20 images
    state = random_model(DDP_DEPTH, torch.Generator().manual_seed(14)) \
        .state_dict()
    x = [r["file_path_image"] for r in train]
    y = [r["file_path_mask_eroded_0_dilated_0"] for r in train]
    images = torch.from_numpy(np.stack([load_image(p) for p in x[:BATCH]]))
    targets = torch.from_numpy(np.stack([load_target(p)
                                         for p in y[:BATCH]]))
    batch = {k: v.cpu() for k, v in eval_batch_resize(
        images, targets, TRAIN_SIZE).items()}
    batch_path = PARALLEL_DIR / "batch.pt"
    torch.save(batch, batch_path)
    ref, ref_ms = {"init": state}, {}
    for name, dtype in DDP_DTYPES:
        start = time.perf_counter()
        loss, grads, stats = step_outputs(state, batch, dtype)
        ref_ms[name] = 1e3 * (time.perf_counter() - start)
        ref[name] = {"loss": loss,
                     "grads": {n: g.cpu() for n, g in grads.items()},
                     "stats": {k: v.cpu() for k, v in stats.items()}}
        del grads, stats
        torch.cuda.empty_cache()
    floor = rel_errors(ref["f32"]["grads"], ref["f64"]["grads"])
    farthest = max(floor, key=floor.get)
    bf16_l2 = l2_distance(ref["bf16"]["grads"], ref["f64"]["grads"])
    reference_path = PARALLEL_DIR / "reference.pt"
    torch.save(ref, reference_path)
    print(f"parallel: (c) single-process steps (dropout_2d 0.1): float32 "
          f"loss {ref['f32']['loss']:.6f}, float64 {ref['f64']['loss']:.6f}"
          f", bf16 {ref['bf16']['loss']:.6f}; the float32 gradients sit up "
          f"to {floor[farthest]:.3g} of a tensor's max from the float64 "
          f"ones ({farthest}), "
          f"{l2_distance(ref['f32']['grads'], ref['f64']['grads']):.3g} "
          f"relative in L2 over all tensors, the bf16 ones {bf16_l2:.3g}; "
          f"{ref_ms['f32']:.1f} / {ref_ms['f64']:.1f} / "
          f"{ref_ms['bf16']:.1f} ms (host clock, first step of a process)")
    loss_ref = {name: ref[name]["loss"] for name, _ in DDP_DTYPES}
    del ref
    n = FIT_STEPS * BATCH
    state_path = PARALLEL_DIR / "state.pt"
    torch.save(state, state_path)
    checkpoint_dir = PARALLEL_DIR / "ck_ranks"
    runs = {}
    for devices in ([card, card], [card]):
        start = time.perf_counter()
        if len(devices) == 2:  # with (d) on the same ranks
            runs[2] = distributed.spawn(parallel_rank, devices, setup,
                                        reference_path, batch_path,
                                        state_path, x[:n], y[:n],
                                        checkpoint_dir)
            got = [r["step"] for r in runs[2]]
        else:
            got = distributed.spawn(ddp_step_rank, devices, setup,
                                    reference_path, batch_path)
        seconds = time.perf_counter() - start
        for r in got:
            f32, f64, bf16 = r["f32"], r["f64"], r["bf16"]
            print(f"parallel: (c) rank {r['rank']} of {len(devices)} "
                  f"({r['backend']}, {devices}): float64 loss "
                  f"{f64['loss']:.9f}, worst gradient {f64['grad_err']:.3g} "
                  f"of its max ({f64['worst']}; tolerance {DDP_GRAD_TOL}), "
                  f"running statistics {f64['stat_err']:.3g} (tolerance "
                  f"{DDP_STAT_TOL}); float32 loss {f32['loss']:.6f}, "
                  f"statistics {f32['stat_err']:.3g}, gradients up to "
                  f"{f32['grad_err']:.3g} of a tensor's max from one "
                  f"process's float32 ({f32['worst']}; not gated: see "
                  f"above), {f32['l2']:.3g} relative in L2 ({f32['l2_f64']:.3g}"
                  f" from float64); bf16 loss {bf16['loss']:.6f} (tolerance "
                  f"{BF16_LOSS_TOL:.3g} relative), gradients {bf16['l2']:.3g} "
                  f"relative in L2 from one process's bf16 (tolerance "
                  f"{BF16_L2_MARGIN} x {bf16_l2:.3g}), {bf16['l2_f64']:.3g} "
                  f"from float64; spawn to exit {seconds:.1f} s"
                  + (" with (d)" if len(devices) == 2 else ""))
            for name, v in (("f32", f32), ("f64", f64)):
                want = loss_ref[name]
                if not (abs(v["loss"] - want) <= DDP_LOSS_TOL * abs(want)
                        and v["stat_err"] <= DDP_STAT_TOL):
                    raise AssertionError(f"parallel: (c) rank {r['rank']} "
                                         f"of {len(devices)}: {name} loss or "
                                         f"statistics differ")
            if f64["grad_err"] > DDP_GRAD_TOL:
                raise AssertionError(f"parallel: (c) rank {r['rank']} of "
                                     f"{len(devices)}: gradients differ from "
                                     f"the single-process step")
            if not (abs(bf16["loss"] - loss_ref["bf16"])
                    <= BF16_LOSS_TOL * abs(loss_ref["bf16"])
                    and bf16["l2"] <= BF16_L2_MARGIN * bf16_l2):
                raise AssertionError(f"parallel: (c) rank {r['rank']} of "
                                     f"{len(devices)}: the bf16 step differs "
                                     f"from one process's: {bf16}")

    # (d) bf16 UNetTrainer.fit on the two-rank mesh (run above, after
    # (c)), then a two-rank resume, beside one process on the same files
    single = fit_rank(setup, state_path, x[:n], y[:n],
                      PARALLEL_DIR / "ck_single", 1)
    first = [r["fit"] for r in runs[2]]
    resumed = [r["resumed"] for r in runs[2]]
    payload, aux = resume_files(checkpoint_dir)
    for r in first:
        if r["step"] != FIT_STEPS or r["next_epoch"] != 0:
            raise AssertionError(f"parallel: (d) rank {r['rank']}'s first "
                                 f"fit: {r}")
    for r in resumed:
        if r["next_epoch"] != 1 or r["step"] != 2 * FIT_STEPS:
            raise AssertionError(f"parallel: (d) rank {r['rank']} did not "
                                 f"resume at epoch 1: {r}")
    if payload["step"] != 2 * FIT_STEPS or aux["epoch_id"] != 1:
        raise AssertionError("parallel: (d) the resumed run's last.pt")
    losses = first[0]["losses"] + resumed[0]["losses"]
    if not np.isfinite(losses).all() or \
            first[0]["losses"] != first[1]["losses"]:
        raise AssertionError(f"parallel: (d) losses {first}")
    # the first step starts from the same weights on the same global batch
    if abs(losses[0] - single["losses"][0]) > BF16_LOSS_TOL * abs(
            single["losses"][0]):
        raise AssertionError(f"parallel: (d) the ranks' first bf16 loss "
                             f"{losses[0]} against one process's "
                             f"{single['losses'][0]}")

    def ms(seconds):
        return [round(1e3 * s, 2) for s in seconds]

    print(f"parallel: (d) bf16 fit of {FIT_STEPS} steps of {BATCH} "
          f"({TRAIN_SIZE[0]}x{TRAIN_SIZE[1]}, from phase 6's files) on 2 gloo "
          f"ranks sharing the card: "
          f"rank 0 wrote last.pt (step {FIT_STEPS}, epoch 0), a 2-rank "
          f"resume continued at epoch 1 to step {payload['step']}; first "
          f"loss within {BF16_LOSS_TOL:.3g} relative of one process's; losses "
          f"{[round(v, 5) for v in losses]} (single-process "
          f"{[round(v, 5) for v in single['losses']]}); ms/step (host clock,"
          f" loss read back) ranks {ms(first[0]['seconds'])}, resumed "
          f"{ms(resumed[0]['seconds'])}, single process "
          f"{ms(single['seconds'])} on {smi}")
    print(f"parallel: phase 14 took {time.perf_counter() - phase_start:.2f} "
          f"s; CCL launches {launches}")
    return launches


class Softmax64(torch.nn.Module):
    """(B, H, W, 3) -> the float64 softmax of a float64 model: phase 15
    (b)'s forward, whose probabilities stay in float64."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images):
        logits = self.model(images.permute(0, 3, 1, 2).to(torch.float64))
        return torch.softmax(logits, 1).permute(0, 2, 3, 1)


def spatial_tile(side):
    """A (1, side, side, 3) uint8 tile of phase 6's synthetic train tiles
    (the crowded and the empty one left out), laid side by side."""
    from mapping_tpu_torch.data.loader import load_image

    per = -(-side // TILE)
    paths = sorted((PREP_DIR / "data" / "train" / "images").iterdir())
    tiles = [load_image(str(p)) for p in paths[2:2 + per * per]]
    rows = [np.concatenate(tiles[r * per:(r + 1) * per], 1)
            for r in range(per)]
    return torch.from_numpy(np.concatenate(rows, 0)[None, :side, :side])


def spatial_compare(what, single, spatial, images, reps=0):
    """Phase 15: `spatial` (a FusedServe over bands) against `single` on
    `images`: the band rule of phase 14 (a) (labels equal, or different
    only at pixels whose single-device probability lies within max
    |p_spatial - p_single| of the threshold, that band at most BAND_CEIL),
    and with `reps` the ms per call of each (CUDA events, in turns), each
    one's peak device memory and the exchange of one call."""
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.parallel.spatial import EXCHANGE

    th, tw = single._post["target_size"]
    with torch.inference_mode():
        p_single = resize_bilinear(single._probs(images), (th, tw))
        p_spatial = spatial.spatial(images).to(p_single.dtype)
    band = float((p_spatial - p_single).abs().max())
    out = {"band": band}
    before = dict(K.LAUNCHES)
    EXCHANGE.reset()
    handle = spatial.dispatch(images)
    out["exchange"] = EXCHANGE.as_dict()
    out["launches"] = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    got = spatial.collect(handle)  # with the overflow reruns, if any
    out["all_launches"] = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    want = single(images)
    if band > BAND_CEIL:
        raise AssertionError(f"spatial: {what}: max |dp| {band:.3g} above "
                             f"{BAND_CEIL}")
    out["differ"] = instances_agree(got, want, p_single[..., 1], band)
    out["labels"] = got[0]
    if reps:
        ms = {"single": [], "spatial": []}
        for name in ("single", "spatial", "spatial", "single"):
            fn = single if name == "single" else spatial
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(images)
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / reps)
            out[f"{name}_peak_gib"] = max(
                out.get(f"{name}_peak_gib", 0.0),
                torch.cuda.max_memory_allocated() / 2 ** 30)
        out["ms"] = {k: float(np.mean(v)) for k, v in ms.items()}
    return out


def spatial_phase(smi, prepared):
    """Phase 15: spatial serving on the one card."""
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.data.augment import (normalize_image,
                                                resize_bilinear)
    from mapping_tpu_torch.data.metadata import read_metadata
    from mapping_tpu_torch.infer.postprocess import active_layers_for
    from mapping_tpu_torch.infer.serving import FusedServe
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.models.quantize import (QuantizedProbs,
                                                   quantized_probs_fn)
    from mapping_tpu_torch.models.registry import build_network
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.parallel import Mesh
    from mapping_tpu_torch.parallel.spatial import SpatialProgram
    from mapping_tpu_torch.pipelines import PIPELINES

    phase_start = time.perf_counter()
    shutil.rmtree(SPATIAL_DIR, ignore_errors=True)
    SPATIAL_DIR.mkdir(parents=True)
    card = "cuda:0" if DEVICE == "cuda" else DEVICE
    weights = TRAIN_DIR / "full" / "transformers" / "unet.pt"
    state = torch.load(weights, map_location="cpu", weights_only=True)
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=active_layers_for(CATEGORY_IDS, (1, 1)))
    launches = {k: 0 for k in K.LAUNCHES}

    def meshes(n):
        return Mesh([card] * n)

    # (a) one large tile, bf16, on 2 and 4 bands against the unsplit forward
    tile = spatial_tile(SPATIAL_SIDE)
    image = normalize_image(tile.to(card))
    t = trainer("bfloat16", state)
    probs = t.probs_apply_fn()
    wide = dict(post, max_instances=SPATIAL_PAD)
    single = FusedServe(probs, **wide)
    with torch.inference_mode():  # how far bf16 itself moves them
        f32 = trainer("float32", state).probs_apply_fn()
        own = float((resize_bilinear(f32(image), (TILE, TILE))
                     - resize_bilinear(probs(image), (TILE, TILE))
                     ).abs().max())
    del f32
    for n in SPATIAL_BANDS:
        spatial = FusedServe(probs, mesh=meshes(n), spatial=True, **wide)
        r = spatial_compare(f"(a) {n} bands", single, spatial, image, reps=3)
        for k in launches:
            launches[k] += r["all_launches"][k]
        ex = r["exchange"]
        if not ex["max_rows"] < SPATIAL_SIDE or not r["all_launches"][
                "ccl_label_raw"] == 1:
            raise AssertionError(f"spatial: (a) {n} bands: the largest "
                                 f"transfer has {ex['max_rows']} rows, the "
                                 f"CCL label launched {r['launches']}")
        print(f"spatial: (a) one {SPATIAL_SIDE}^2 tile of phase 6's "
              f"buildings, ResNet101 bf16 (phase 9 (a)'s weights), target "
              f"{TILE}^2, {n} bands on {card}: max |dp| {r['band']:.3g} "
              f"(limit {BAND_CEIL}; one device's bf16 from its float32 "
              f"{own:.3g}), {r['differ']} image(s) with other "
              f"labels ({int(r['labels'].max())} instances); exchange per "
              f"call: halo {ex['halo_bytes'] / 2 ** 20:.2f} MiB, gather "
              f"{ex['gather_bytes'] / 2 ** 20:.2f} MiB in {ex['transfers']} "
              f"transfers, the largest {ex['max_rows']} rows (the map has "
              f"{SPATIAL_SIDE}); ms per tile (CUDA events) single "
              f"{r['ms']['single']:.2f}, spatial {r['ms']['spatial']:.2f}; "
              f"peak device memory single {r['single_peak_gib']:.3f} GiB, "
              f"spatial {r['spatial_peak_gib']:.3f} GiB; CCL launches "
              f"{r['all_launches']} (instance pad {SPATIAL_PAD}) on {smi}")
    del t, probs, single, spatial
    torch.cuda.empty_cache()

    # (b) the float64 equality gate: 4 bands against the unsplit forward
    h, w = SPATIAL_F64
    f64 = Softmax64(trainer("float32", state).folded_float32().to(
        torch.float64)).eval()
    x = image[:, :h, :w].to(torch.float64)
    with torch.inference_mode():
        want = f64(x)
        bands = SpatialProgram(f64)(x, [card] * 4)
        dp = float((torch.cat(bands.parts, 1) - want).abs().max())
    before = dict(K.LAUNCHES)
    got = FusedServe(f64, mesh=meshes(4), spatial=True, **post)(x)
    for k in launches:
        launches[k] += K.LAUNCHES[k] - before[k]
    ref = FusedServe(f64, **post)(x)
    same = all(np.array_equal(a, b) for a, b in zip(got[::2], ref[::2]))
    print(f"spatial: (b) float64 {h} x {w} tile, 4 bands on {card}: max |dp| "
          f"{dp:.3g} against the unsplit float64 forward (limit "
          f"{SPATIAL_F64_TOL}); labels and areas equal: {same} "
          f"({int(got[0].max())} instances)")
    if not (dp <= SPATIAL_F64_TOL and same):
        raise AssertionError("spatial: (b) the float64 bands differ from "
                             "the unsplit forward")
    del f64, bands, want
    torch.cuda.empty_cache()

    # (c) the product shape: the val tiles at batch 20 through the
    # pipeline's forward over two bands, against one device
    experiment = SPATIAL_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(weights, experiment / "transformers" / "unet.pt")
    config = write_config("serving", {
        "data_dir": str(PREP_DIR / "data"),
        "meta_dir": str(prepared["meta_dir"]),
        "experiment_dir": str(experiment), "device": DEVICE,
        "evaluation_data_sample": PREP_VAL}, SPATIAL_DIR)
    pipe = PIPELINES["unet_weighted"]["inference"](build_config(config))
    pipe._ensure_weights()
    valid = [r for r in read_metadata(prepared["meta_dir"] / "metadata.csv")
             if r["is_valid"] == 1]
    flow, steps = pipe.loader.transform(
        [r["file_path_image"] for r in valid], None,
        train_mode=False)["datagen"]
    batches = [b["image"] for _, b in zip(range(steps), flow)]
    args = pipe._serve_args(False)
    single = FusedServe(pipe._probs_fn(), **args)
    spatial = FusedServe(pipe._probs_fn(), mesh=meshes(2), spatial=True,
                         **args)
    bands, differ, plain_equal = 0.0, 0, True
    for b in batches:
        r = spatial_compare("(c)", single, spatial, b)
        if r["launches"]["ccl_label_raw"] != 1:
            raise AssertionError(f"spatial: (c) CCL launches {r['launches']}"
                                 f" for one batch")
        for k in launches:
            launches[k] += r["all_launches"][k]
        bands, differ = max(bands, r["band"]), differ + r["differ"]
        with torch.inference_mode():
            masks = (spatial.spatial(b)[..., 1] > 0.5).contiguous()
            plain = _renumber(_label_raw(masks, 2 * TILE))
        plain_equal &= np.array_equal(
            r["labels"][:, 1], torch.clamp(plain, max=32767).cpu().numpy())
    one_card = write_config("one_card", {
        "data_dir": str(PREP_DIR / "data"),
        "meta_dir": str(prepared["meta_dir"]),
        "experiment_dir": str(experiment), "device": DEVICE,
        "spatial_serving": 1}, SPATIAL_DIR)
    log = SPATIAL_DIR / "one_card.log"
    rc, seconds, _ = run_child(cli_child(one_card, "evaluate", "-p",
                                         "unet_weighted"), log)
    refused = "spatial_serving: 1 needs more than one device" in \
        log.read_text()
    print(f"spatial: (c) FusedServe(mesh=Mesh([{card!r}] * 2), "
          f"spatial=True) over the {len(valid)} val tiles in {len(batches)} "
          f"batches of {BATCH} (256^2 in, {TILE}^2 out) against one device: "
          f"max |dp| {bands:.3g}, {differ} images with other labels within "
          f"that band; the CCL label launched once a batch on {card}, its "
          f"labels equal to the plain CCL's on those masks: {plain_equal}; "
          f"the CLI with spatial_serving: 1 on {torch.cuda.device_count()} "
          f"visible card(s) exited {rc} in {seconds:.1f} s with JAX's "
          f"message: {refused}")
    if not (plain_equal and rc != 0 and refused):
        raise AssertionError("spatial: (c) the kernel's labels or the "
                             "one-card refusal")
    del pipe, single, spatial, batches
    torch.cuda.empty_cache()

    # (d) families and the int8 forward, seeded weights, one tile each
    side, n = SPATIAL_FAMILY_SIDE, SPATIAL_FAMILY_BANDS
    small = image[:, :side, :side].contiguous()
    torch.manual_seed(0)
    forwards = []
    for encoder, extra in SPATIAL_FAMILIES:
        model = {"encoder": encoder, **extra}
        seeded = centre_logits(build_network(model), small)
        forwards.append((f"{encoder} (float32)", trainer(
            "float32", seeded, model=model).probs_apply_fn()))
    t32 = trainer("float32", state)
    forwards.append(("int8 ResNet101 (bf16 between the int8 convs)",
                     QuantizedProbs(*quantized_probs_fn(
                         t32.folded_float32, small,
                         compute_dtype=torch.bfloat16))))
    for name, fn in forwards:
        r = spatial_compare(f"(d) {name}", FusedServe(fn, **post),
                            FusedServe(fn, mesh=meshes(n), spatial=True,
                                       **post), small)
        for k in launches:
            launches[k] += r["all_launches"][k]
        print(f"spatial: (d) {name}, one {side}^2 tile, {n} bands: max |dp| "
              f"{r['band']:.3g}, {r['differ']} image(s) with other labels "
              f"within that band ({int(r['labels'].max())} instances)")
    print(f"spatial: phase 15 took {time.perf_counter() - phase_start:.2f} "
          f"s; CCL launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"spatial: CCL launches {launches}")
    return launches


def jpeg_geometries(rng, n):
    """`n` drawn (geometry, batch) cases for phase 16 (a): every sampling
    the decoder takes (ratios 1 and 2 each way, and 3 and 4, which
    libjpeg box-replicates; factors up to 4), grey, YCbCr, RGB, and four
    components as CMYK and as YCCK (a file with or without an Adobe
    marker), sizes from 1x1 up to 3,000 wide (past the width at which a
    CTA's row of MCUs is cut into chunks), batches 1-32."""
    from mapping_tpu_torch.utils.jpeg import Geometry

    samplings = [((1, 1), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
                 ((2, 1), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1)),
                 ((2, 2), (2, 2), (2, 2)), ((2, 2), (2, 1), (1, 2)),
                 ((4, 4), (2, 2), (2, 2)), ((4, 2), (2, 1), (2, 2)),
                 ((1, 1), (2, 2), (1, 1)), ((2, 2), (1, 2), (2, 1)),
                 ((1, 2), (1, 1), (1, 2)), ((4, 1), (1, 1), (1, 1)),
                 ((1, 4), (1, 1), (1, 1)), ((4, 2), (1, 1), (1, 1)),
                 ((3, 1), (1, 1), (1, 1)), ((3, 3), (1, 1), (1, 1)),
                 ((2, 4), (1, 1), (1, 1)), ((1, 3), (1, 1), (1, 1)),
                 ((4, 2), (2, 2), (1, 1))]
    four = [((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2)),
            ((2, 1), (1, 1), (1, 1), (2, 1)), ((2, 2), (1, 1), (1, 1), (1, 1)),
            ((4, 1), (1, 1), (1, 1), (2, 1))]
    cases = []
    for i in range(n):
        kind = i % 10
        if kind == 0:  # wide: chunks of MCU columns, halo columns
            h, w, batch = int(rng.randint(1, 40)), int(rng.randint(
                700, 3001)), int(rng.randint(1, 4))
        elif kind == 1:  # tiny
            h, w, batch = int(rng.randint(1, 9)), int(rng.randint(1, 9)), \
                int(rng.randint(1, 33))
        else:
            h, w = (int(round(math.exp(rng.uniform(0, math.log(400)))))
                    for _ in range(2))
            batch = int(rng.randint(1, 33))
        color = ("gray", "ycc", "ycc", "ycc", "rgb", "cmyk",
                 "ycck")[int(rng.randint(7))]
        if color == "gray":
            factors = ((1, 1),)
        elif color in ("cmyk", "ycck"):
            factors = four[int(rng.randint(len(four)))]
        else:
            factors = samplings[int(rng.randint(len(samplings)))]
        # at most JPEG_DRAWN_PIXELS a case, which keeps (a) to seconds
        batch = max(1, min(batch, JPEG_DRAWN_PIXELS // (h * w)))
        cases.append((Geometry(h, w, factors, color), batch))
    return cases


def jpeg_inputs(rng, geometry, batch):
    """Random coefficients of `batch` images of `geometry`: most blocks at
    a JPEG's magnitudes, some whole blocks at int16's ends and, under a
    quant table of 2s, at and one past the 32-bit IDCT's first-pass bound
    (kernels/jpeg.PASS1_LIMIT); quant tables of 8 and 16 bits, and one
    entry at the 16-bit end (QUANT_MAX) in a fifth of the cases."""
    from mapping_tpu_torch.kernels import jpeg as J

    n, comps = geometry.n_blocks, len(geometry.factors)
    scale = rng.choice([4, 64, 1024], size=(batch, n, 1))
    coef = (rng.standard_normal((batch, n, 64)) * scale /
            (1 + np.arange(64))).round().clip(-32768, 32767)
    edge = J.PASS1_LIMIT // 2  # x 2 is within the bound, + 1 past it
    wild = rng.random_sample((batch, n)) < 0.03
    coef[wild] = rng.choice([-32768, 32767, -edge, edge, edge + 1,
                             -edge - 1], size=(int(wild.sum()), 64))
    quant = rng.randint(1, 256, (batch, comps, 64))
    kind = rng.randint(5)
    if kind == 0:
        quant[:] = 1
    elif kind == 1:
        quant[:] = 2
    elif kind == 2:
        quant[:, :, :4] = rng.randint(1, 65536, (batch, comps, 4))
    elif kind == 3:
        quant[:, -1, 0] = J.QUANT_MAX
    return (torch.from_numpy(coef.astype(np.int16)),
            torch.from_numpy(quant.astype(np.int32)))


def jpeg_check(coef, quant, geometry, what, err):
    """`jpeg_pixels` on the card against the plain version on the card's
    copy of the same inputs, exactly; the largest difference seen goes
    into err; returns the kernel's RGB on the host."""
    from mapping_tpu_torch.kernels import jpeg as J

    coef, quant = coef.to(DEVICE), quant.to(DEVICE)
    want = J.pixels_plain(coef, quant, geometry)
    got = J.pixels_cuda(coef, quant, geometry)
    e = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    err["jpeg_pixels"] = max(err.get("jpeg_pixels", 0), e)
    if e:
        raise AssertionError(f"{what}: jpeg_pixels differs from the plain "
                             f"version by {e}")
    return got.cpu()


def jpeg_threads():
    """Phase 16 (a): handler threads decoding bodies of different
    geometries at once through one DeviceDecoder, as the daemon's do: a
    4:4:4 picture 2,000 wide (chunks of MCU columns, the most shared
    memory a CTA) and a grey 16^2 one (a few KB), JPEG_THREAD_CALLS calls
    from each of two threads, every result = the plain version's."""
    from mapping_tpu_torch.utils import jpeg, native_decode

    rng = np.random.RandomState(17)
    items = [native_decode.read_bytes(jpeg.encode(
        rng.randint(0, 256, shape).astype(np.uint8), 90, "4:4:4"))
        for shape in ((24, 2000, 3), (16, 16))]
    want = [native_decode.assemble([it], "cpu") for it in items]
    decoder = native_decode.DeviceDecoder(DEVICE)

    def calls(k):
        for _ in range(JPEG_THREAD_CALLS):
            images, _ = decoder([items[k]])
            if not torch.equal(images.cpu(), want[k]):
                return False
        return True

    start = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        ok = list(pool.map(calls, range(len(items))))
    if not all(ok):
        raise AssertionError(f"a threaded decode differs from the plain "
                             f"version: {ok}")
    print(f"jpeg: (a) two threads, {JPEG_THREAD_CALLS} calls each of one "
          f"DeviceDecoder at {[it.geometry for it in items]}: all = plain, "
          f"in {time.perf_counter() - start:.2f} s")


def jpeg_exactness(err):
    """Phase 16 (a): the corpus (the JAX package's digests, the refused
    kinds) and JPEG_DRAWN drawn geometries, `jpeg_pixels` = plain exactly,
    and a quant table past 16 bits refused."""
    import hashlib

    from mapping_tpu_torch.kernels import jpeg as J
    from mapping_tpu_torch.utils import jpeg, native_decode

    # the corpus: the JAX package's digests, and the refused kinds
    manifest = json.loads((JPEG_CORPUS / "manifest.json").read_text())
    decoded = []
    for name, entry in sorted(manifest.items()):
        data = (JPEG_CORPUS / name).read_bytes()
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise AssertionError(f"{name}: not the committed file")
        if "refused" in entry:
            try:
                native_decode.decode_rgb_batch([JPEG_CORPUS / name], DEVICE)
            except ValueError as e:
                if entry["refused"] not in str(e):
                    raise AssertionError(f"{name}: {e}") from e
                print(f"jpeg: (a) {name} refused: {e}")
                continue
            raise AssertionError(f"{name} decoded; it should be refused")
        if is_lossless_jpeg(name):  # decoded on the host (phase 21)
            continue
        c = jpeg.read(data)
        rgb = jpeg_check(torch.from_numpy(c.coef)[None],
                         torch.from_numpy(c.quant)[None], c.geometry, name,
                         err)
        if hashlib.sha256(rgb[0].numpy().tobytes()).hexdigest() \
                != entry["decode_sha256"]:
            raise AssertionError(f"{name}: the card's decode is not "
                                 f"the JAX package's")
        decoded.append(f"{name} {c.geometry.factors} {c.geometry.color}")
    print(f"jpeg: (a) {len(decoded)} corpus files decode on the card to "
          f"the JAX package's digests, jpeg_pixels = plain exactly: "
          f"{'; '.join(decoded)}")
    start = time.perf_counter()
    rng = np.random.RandomState(16)
    cases = jpeg_geometries(rng, JPEG_DRAWN)
    images = 0
    for i, (g, batch) in enumerate(cases):
        coef, quant = jpeg_inputs(rng, g, batch)
        jpeg_check(coef, quant, g, f"drawn case {i} {g} batch {batch}", err)
        images += batch
    quant[:, 0, 0] = J.QUANT_MAX + 1
    try:
        J.pixels_cuda(coef.to(DEVICE), quant.to(DEVICE), g)
    except ValueError as e:
        print(f"jpeg: (a) a quant table past 16 bits refused: {e}")
    else:
        raise AssertionError("a quant table past 16 bits was taken")
    print(f"jpeg: (a) {len(cases)} drawn geometries ({images} images, "
          f"{sum(g.color == 'gray' for g, _ in cases)} grey, "
          f"{sum(g.color == 'rgb' for g, _ in cases)} RGB, widths up to "
          f"{max(g.width for g, _ in cases)}, "
          f"{len({g.factors for g, _ in cases})} samplings, batches "
          f"{min(b for _, b in cases)}-{max(b for _, b in cases)}): "
          f"jpeg_pixels = plain exactly, in "
          f"{time.perf_counter() - start:.2f} s")


def jpeg_times(items, smi, err):
    """Phase 16 (c): `jpeg_pixels` on 300^2 tiles (their coefficients
    `items`, cycled) at each of JPEG_BATCHES, first held equal to the
    plain version (the largest difference into err), then as CUDA-graph
    replays, in turns with the parent tree's jpeg_pixels where a copy lies
    under build/old/ and with the plain version; returns {batch: (ms,
    plain ms, library ms)} and {batch: bound}."""
    from mapping_tpu_torch.kernels import bounds, jpeg as J

    g = items[0].geometry
    old = old_kernels().get("jpeg_pixels")

    def replays(fn, reps):
        return graph_ms(fn, reps, JPEG_GRAPH_CALLS)

    n_comp = len(g.factors)
    times, bound = {}, {}
    for batch in JPEG_BATCHES:
        pick = [items[i % len(items)] for i in range(batch)]
        coef = torch.from_numpy(np.stack([c.coef for c in pick])).to(DEVICE)
        quant = torch.from_numpy(np.stack([c.quant for c in pick])).to(
            DEVICE)
        fns = {"kernel": lambda: J.pixels_cuda(coef, quant, g),
               "plain": lambda: J.pixels_plain(coef, quant, g)}
        timer = {"kernel": replays, "plain": cuda_ms}
        reps = {"kernel": JPEG_REPS,
                "plain": JPEG_PLAIN_REPS if batch <= BATCH else 3}
        jpeg_check(coef, quant, g, f"the timed batch of {batch}", err)
        if old is not None:
            if not torch.equal(old(coef, quant, g), fns["kernel"]()):
                raise AssertionError(f"the parent's jpeg_pixels and this one "
                                     f"differ at batch {batch}")
            fns["parent"] = lambda: old(coef, quant, g)
            timer["parent"], reps["parent"] = replays, JPEG_REPS
        timed = in_turns(fns, timer, reps)
        bound[batch] = bounds.jpeg_pixels(batch, g.n_blocks, n_comp,
                                          g.height, g.width)
        times[batch] = (min(timed["kernel"]), min(timed["plain"]), None)
        print(f"jpeg: (c) at ({batch}, {TILE}^2, 4:2:0), {g.n_blocks} "
              f"blocks a tile: jpeg_pixels {timed['kernel']} ms "
              f"(CUDA-graph replays of {JPEG_GRAPH_CALLS} calls, in turns), "
              + (f"the parent's jpeg_pixels {timed['parent']} ms, "
                 if old is not None else "no parent tree under build/old, ")
              + f"plain {timed['plain']} ms; bound {bound[batch][0]:.5f} ms "
              f"({bound[batch][1]}), kernel / bound "
              f"{min(timed['kernel']) / bound[batch][0]:.2f} on {smi}")
    return times, bound


def jpeg_phase(smi, png_run):
    """Phase 16: the port's JPEG decoder on the card. Returns (max |kernel
    - plain| per kernel, (ms, plain ms, library ms) per kernel, the main
    path's launches per kernel, the bound per kernel)."""
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.infer.daemon import decode_request_image
    from mapping_tpu_torch.kernels import ccl, jpeg as J
    from mapping_tpu_torch.utils import jpeg, native_decode

    begin = time.perf_counter()
    err = {"jpeg_pixels": 0}
    jpeg_exactness(err)
    jpeg_threads()

    # (b) phase 8's val split as JPEG: the card's batch = the CPU's, then
    # `evaluate` through the CLI on phase 9 (a)'s weights
    shutil.rmtree(JPEG_DIR, ignore_errors=True)
    data, experiment = JPEG_DIR / "data", JPEG_DIR / "experiment"
    write_split(data, "val", EVAL_TILES, np.random.RandomState(8),
                fmt="jpeg")
    paths = sorted((data / "val" / "images").glob("*.jpg"))
    on_card = native_decode.decode_rgb_batch(paths, DEVICE)
    on_cpu = native_decode.decode_rgb_batch(paths, "cpu")
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError("the val tiles decode differently on the card")
    served = native_decode.DeviceDecoder(DEVICE)  # the daemon's
    for i, path in enumerate(paths[:BATCH]):
        tile = decode_request_image(path.read_bytes(), "image/jpeg",
                                    (TILE, TILE), served)
        if not (isinstance(tile, torch.Tensor) and tile.is_cuda
                and torch.equal(tile.cpu(), on_cpu[i])):
            raise AssertionError(f"{path.name}: the daemon's decode differs "
                                 f"or left the card")
    print(f"jpeg: (b) {len(paths)} val tiles (quality 95, 4:2:0) decode on "
          f"the card equal to the CPU decode, exactly; so do {BATCH} of "
          f"them as request bodies through the daemon's decoder, their "
          f"tiles left on the card for the batcher")
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    config = write_config("jpeg", {
        "data_dir": str(data), "meta_dir": str(JPEG_DIR / "meta"),
        "experiment_dir": str(experiment), "device": DEVICE,
        **EVAL_PARAMS}, where=JPEG_DIR)
    cli.main(["--config", config, "prepare_metadata", "-val"])
    torch.cuda.synchronize()
    ccl.reset_launches()
    J.reset_launches()
    run_start = time.perf_counter()
    manager = cli.main(["--config", config, "evaluate", "-p",
                        "unet_weighted"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - run_start
    launched = {"jpeg": dict(J.LAUNCHES), "ccl": dict(ccl.LAUNCHES)}
    check_prediction(experiment / "prediction.json",
                     set(range(1, EVAL_TILES + 1)), "JPEG evaluate")
    ap, ar = last_scores(experiment)
    batches = -(-EVAL_TILES // BATCH)  # one geometry: a launch a batch
    if launched["jpeg"] != {"jpeg_pixels": batches} \
            or min(launched["ccl"].values(), default=0) < 1:
        raise AssertionError(f"the JPEG evaluate launched {launched['jpeg']} "
                             f"(expected jpeg_pixels {batches}), CCL "
                             f"{launched['ccl']}")
    t = manager.timings
    print(f"jpeg: (b) `evaluate -p unet_weighted` on the JPEG tiles, in "
          f"this process: {run_s:.2f} s, AP/AR {ap}/{ar}; launches "
          f"{launched['jpeg']} (one a batch, {batches} batches) "
          f"{launched['ccl']}, {t['images'] / t['total_s']:.2f} images/s, "
          f"decode_s {t['decode_s']:.4f} (to the kernel's end), device_s "
          f"{t['device_s']:.4f}, annotation_s {t['annotation_s']:.4f}, "
          f"cocoeval_s {t['cocoeval_s']:.4f}; phase 8's PNG run in process: "
          f"{png_run['images'] / png_run['total_s']:.2f} images/s, decode_s "
          f"{png_run['decode_s']:.4f} (host clock) on {smi}")

    # (c) times at the daemon's batch, the serving batch and a large one
    times, bound = jpeg_times(
        [jpeg.read(p.read_bytes()) for p in paths], smi, err)
    blobs = [p.read_bytes() for p in paths] * (
        -(-JPEG_ENTROPY_TILES // len(paths)))
    blobs = blobs[:JPEG_ENTROPY_TILES]
    start = time.perf_counter()
    for b in blobs:
        jpeg.read(b)
    one = (time.perf_counter() - start) / len(blobs) * 1e3
    with ThreadPoolExecutor(8) as pool:
        start = time.perf_counter()
        list(pool.map(jpeg.read, blobs))
        eight = (time.perf_counter() - start) / len(blobs) * 1e3
    print(f"jpeg: (c) host Huffman decode {one:.4f} ms a tile on 1 thread, "
          f"{eight:.4f} on 8 (host clock) on {smi}")
    seconds = time.perf_counter() - begin
    print(f"jpeg: phase 16 took {seconds:.2f} s")
    if seconds > JPEG_BUDGET_S:
        raise AssertionError(f"phase 16 took {seconds:.2f} s, over its "
                             f"{JPEG_BUDGET_S} s")
    return err, {"jpeg_pixels": times[BATCH]}, launched["jpeg"], \
        {"jpeg_pixels": bound[BATCH]}


def corpus_digests(corpus, read, key, select=None):
    """Phase 17 (a): each file of `corpus` (those `select(name)` takes,
    where given) through `read` (bytes -> RGB): the manifest's JAX digest
    under `key`, or the refusal naming its feature. Returns (files
    decoded, refused)."""
    import hashlib

    manifest = json.loads((corpus / "manifest.json").read_text())
    decoded = refused = 0
    for name, entry in sorted(manifest.items()):
        if select is not None and not select(name):
            continue
        data = (corpus / name).read_bytes()
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise AssertionError(f"{name}: not the committed file")
        if "refused" in entry:
            try:
                read(data)
            except ValueError as e:
                if entry["refused"] not in str(e):
                    raise AssertionError(f"{name}: {e}") from e
                refused += 1
                continue
            raise AssertionError(f"{name} decoded; it should be refused")
        if entry[key] is None:
            continue
        got = hashlib.sha256(np.ascontiguousarray(read(data)).tobytes())
        if got.hexdigest() != entry[key]:
            raise AssertionError(f"{name}: not the JAX package's decode "
                                 f"({key})")
        decoded += 1
    return decoded, refused


def scene_picture(rng, side):
    """A side^2 RGB scene with texture for the entropy coder: gradients
    in 16-pixel steps, noise, and 400 flat rectangles (roofs)."""
    steps = np.arange(side) // 16
    base = (np.add.outer(steps, steps) % 256).astype(np.uint8)
    img = np.stack([base, base[::-1], base[:, ::-1]], -1)
    img += rng.randint(0, 24, img.shape).astype(np.uint8)
    for _ in range(400):
        y, x = rng.randint(0, side - 64, 2)
        h, w = rng.randint(12, 64, 2)
        img[y:y + h, x:x + w] = rng.randint(0, 256, 3)
    return img


def tiff_predict(config, fmt, where=TIFF_DIR):
    """`predict_on_dir -p unet_weighted` over where / fmt in this
    process: (seconds, CCL launches, jpeg_pixels launches, timings)."""
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.kernels import ccl, jpeg as J

    torch.cuda.synchronize()
    ccl.reset_launches()
    J.reset_launches()
    start = time.perf_counter()
    manager = cli.main(["--config", config, "predict_on_dir", "-p",
                        "unet_weighted", "--dir_path", str(where / fmt),
                        "--prediction_path", str(where / f"{fmt}.json")])
    torch.cuda.synchronize()
    return (time.perf_counter() - start, dict(ccl.LAUNCHES),
            J.LAUNCHES["jpeg_pixels"], manager.timings)


def tiff_scene(smi, err):
    """Phase 17 (c): a TIFF_SCENE^2 YCbCr 2x2 scene in TIFF_SCENE_TILE^2
    JPEG tiles through `native_decode.assemble` on the card (one
    `jpeg_pixels` launch), equal to the plain decode on the CPU, each
    tile's kernel pixels = the plain version on the card; `jpeg_pixels`
    timed at the scene's batch beside its bound. Returns the launches."""
    from mapping_tpu_torch.kernels import bounds, jpeg as J
    from mapping_tpu_torch.utils import native_decode, tiff

    side, step = TIFF_SCENE, TIFF_SCENE_TILE
    start = time.perf_counter()
    data = tiff.encode(scene_picture(np.random.RandomState(19), side),
                       "jpeg", photometric=6, tile=(step, step), quality=90)
    encode_s = time.perf_counter() - start
    start = time.perf_counter()
    item = native_decode.read_bytes(data)
    host_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    J.reset_launches()
    start = time.perf_counter()
    card = native_decode.assemble([item], DEVICE)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - start) * 1e3
    launches = J.LAUNCHES["jpeg_pixels"]
    g = item.parts[0][2].geometry
    coef = torch.from_numpy(np.stack([c.coef for _, _, c in item.parts]))
    quant = torch.from_numpy(np.stack([c.quant for _, _, c in item.parts]))
    jpeg_check(coef, quant, g, "the scene's tiles", err)
    start = time.perf_counter()
    plain = native_decode.assemble([item], "cpu")
    cpu_s = time.perf_counter() - start
    if launches != 1 or not torch.equal(card.cpu(), plain):
        raise AssertionError(f"the scene: {launches} jpeg_pixels launches "
                             f"(expected 1), = the plain decode on the CPU "
                             f"{torch.equal(card.cpu(), plain)}")
    coef, quant = coef.to(DEVICE), quant.to(DEVICE)
    timed = [graph_ms(lambda: J.pixels_cuda(coef, quant, g), JPEG_REPS,
                      JPEG_GRAPH_CALLS) for _ in range(2)]
    bound = bounds.jpeg_pixels(len(item.parts), g.n_blocks,
                               len(g.factors), g.height, g.width)
    print(f"tiff: (c) a {side}^2 YCbCr 2x2 JPEG TIFF in {len(item.parts)} "
          f"tiles of {step}^2 ({len(data)} bytes, written in {encode_s:.2f} "
          f"s): host entropy decode {host_ms:.2f} ms "
          f"({host_ms / len(item.parts):.4f} a tile, 1 thread), assemble on "
          f"the card {card_ms:.2f} ms (H2D, {launches} jpeg_pixels launch, "
          f"paste; host clock), = the plain decode on the CPU ({cpu_s:.2f} "
          f"s), each tile's kernel pixels = plain on the card; jpeg_pixels "
          f"at ({len(item.parts)}"
          f", {step}^2, 4:2:0) {timed} ms (CUDA-graph replays of "
          f"{JPEG_GRAPH_CALLS} calls), bound {bound[0]:.5f} ms ({bound[1]}), "
          f"kernel / bound {min(timed) / bound[0]:.2f} on {smi}")
    return launches


def tiff_phase(smi):
    """Phase 17: TIFF tiles and PNG gamma through the port's readers, the
    JPEG-TIFF corpus on the card, predict_on_dir over TIFF tiles (LZW, and
    JPEG) = over the same pixels as PNG, and a JPEG-TIFF scene. Returns
    (the main path's launches, {"jpeg_pixels": max |kernel - plain|})."""
    from mapping_tpu_torch.kernels import jpeg as J
    from mapping_tpu_torch.utils import native_decode, png, tiff

    begin = time.perf_counter()
    err = {"jpeg_pixels": 0}
    libpng = native_decode.available()
    tiffs = corpus_digests(TIFF_CORPUS, native_decode.decode_rgb_bytes,
                           "decode_sha256")
    reads = {"read_bytes": native_decode.decode_rgb_bytes,
             "stdlib RGB": lambda b: png.to_rgb(png.read_png(b)),
             "stdlib grey": lambda b: png.to_gray(png.read_png(b))}
    pngs = {what: corpus_digests(PNG_GAMMA, read, "gray_sha256" if "grey"
                                 in what else "rgb_sha256")
            for what, read in reads.items()}
    print(f"tiff: (a) {tiffs[0]} TIFF corpus files decode on the host to "
          f"the JAX package's digests, {tiffs[1]} refused kinds raise naming "
          f"their feature; PNG gamma corpus (libpng "
          f"{'built' if libpng else 'unavailable'} here): {pngs}")
    jpegs = []

    def on_card(data):
        item = native_decode.read_bytes(data)
        if isinstance(item, tiff.JpegTiles):  # lossless parts: no launch
            jpegs.append({p[2].geometry for p in item.parts
                          if not isinstance(p[2], np.ndarray)})
        images = native_decode.assemble([item], DEVICE)
        if images.device.type != torch.device(DEVICE).type:
            raise AssertionError("a TIFF decode left the card")
        return images[0].cpu().numpy()

    J.reset_launches()
    card = corpus_digests(TIFF_CORPUS, on_card, "decode_sha256")
    corpus_launches = J.LAUNCHES["jpeg_pixels"]
    manifest = json.loads((TIFF_CORPUS / "manifest.json").read_text())
    if card != tiffs or corpus_launches != sum(map(len, jpegs)) \
            or len(jpegs) != sum(name.startswith(("jpeg_", "pil_jpeg"))
                                 and "refused" not in e
                                 for name, e in manifest.items()):
        raise AssertionError(f"the TIFF corpus on the card: {card} (host "
                             f"{tiffs}), {len(jpegs)} JPEG files, "
                             f"{corpus_launches} jpeg_pixels launches")
    print(f"tiff: (a) on the card through native_decode.assemble: {card[0]} "
          f"files to the digests, {len(jpegs)} of them JPEG-compressed "
          f"({corpus_launches} jpeg_pixels launches, one a geometry), "
          f"{card[1]} refused kinds raise naming their feature; (a) took "
          f"{time.perf_counter() - begin:.2f} s")
    part = time.perf_counter()

    # (b) the same pixels as TIFF and as PNG through predict_on_dir; and
    # JPEG TIFF against PNG of its plain-decoded pixels
    shutil.rmtree(TIFF_DIR, ignore_errors=True)
    fixture = synthetic_fixture()
    rng = np.random.RandomState(17)
    tiles = [fixture._make_image(rng, h=TILE, w=TILE, max_buildings=20)[0]
             for _ in range(TIFF_TILES)]
    for fmt in ("tiff", "png", "jpeg_tiff", "jpeg_png"):
        (TIFF_DIR / fmt).mkdir(parents=True)
    for i, tile in enumerate(tiles):
        name = f"tile_{i:03d}"
        data = tiff.encode(tile, "lzw", predictor=2, tile=(
            (128, 128) if i == 0 else None), rows_per_strip=16)
        (TIFF_DIR / "tiff" / f"{name}.tif").write_bytes(data)
        (TIFF_DIR / "png" / f"{name}.png").write_bytes(png.encode_png(tile))
        data = tiff.encode(tile, "jpeg", photometric=6, quality=95, **(
            {"tile": (128, 128)} if i % 2 else {"rows_per_strip": 64}))
        (TIFF_DIR / "jpeg_tiff" / f"{name}.tif").write_bytes(data)
        (TIFF_DIR / "jpeg_png" / f"{name}.png").write_bytes(
            png.encode_png(native_decode.decode_rgb_bytes(data)))
    experiment = TIFF_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    config = write_config("tiff", {
        "data_dir": str(TIFF_DIR), "meta_dir": str(TIFF_DIR / "meta"),
        "experiment_dir": str(experiment), "device": DEVICE,
        **EVAL_PARAMS}, where=TIFF_DIR)
    runs = {fmt: tiff_predict(config, fmt)
            for fmt in ("png", "tiff", "jpeg_png", "jpeg_tiff")}
    for got, want, what in (("tiff", "png", "TIFF"),
                            ("jpeg_tiff", "jpeg_png", "JPEG-TIFF")):
        same = (TIFF_DIR / f"{got}.json").read_bytes() == \
            (TIFF_DIR / f"{want}.json").read_bytes()
        prediction = check_prediction(TIFF_DIR / f"{got}.json",
                                      set(range(TIFF_TILES)), f"{what} tiles",
                                      allow_empty=True)
        seconds, launched, jpeg_launched, timings = runs[got]
        if not same or min(launched.values(), default=0) < 1 \
                or timings["images"] != TIFF_TILES \
                or (got == "jpeg_tiff") != (jpeg_launched > 0):
            raise AssertionError(f"predict_on_dir over {what} tiles: same as "
                                 f"PNG {same}, CCL launches {launched}, "
                                 f"jpeg_pixels {jpeg_launched}, "
                                 f"{timings['images']} images")
        print(f"tiff: (b) predict_on_dir over {TIFF_TILES} {what} tiles ("
              + ("LZW, predictor 2, one tiled" if got == "tiff" else
                 "YCbCr 2x2, quality 95, four in 64-row strips, four in "
                 "128^2 tiles")
              + f") wrote the same prediction.json as over PNG tiles of "
              f"{'the same' if got == 'tiff' else 'their plain-decoded'} "
              f"pixels ({len(prediction)} instances); {what} {seconds:.2f} "
              f"s, decode_s {timings['decode_s']:.4f}, PNG "
              f"{runs[want][0]:.2f} s, decode_s {runs[want][3]['decode_s']:.4f}"
              f" (host clock); CCL launches {launched}, jpeg_pixels "
              f"{jpeg_launched} on {smi}")
    launched = {"jpeg_pixels": runs["jpeg_tiff"][2]}
    for fmt in ("tiff", "jpeg_tiff"):
        for name, n in runs[fmt][1].items():
            launched[name] = launched.get(name, 0) + n

    print(f"tiff: (b) took {time.perf_counter() - part:.2f} s")
    part = time.perf_counter()
    launched["jpeg_pixels"] += tiff_scene(smi, err)
    print(f"tiff: (c) took {time.perf_counter() - part:.2f} s")
    seconds = time.perf_counter() - begin
    print(f"tiff: phase 17 took {seconds:.2f} s; main-path launches "
          f"{launched}")
    if seconds > TIFF_BUDGET_S:
        raise AssertionError(f"phase 17 took {seconds:.2f} s, over its "
                             f"{TIFF_BUDGET_S} s")
    return launched, err


def webp_phase(smi):
    """Phase 18: the WebP corpus through the port's reader, predict_on_dir
    over lossy and lossless WebP tiles = over the same pixels as PNG, and
    the host decode's ms a tile. Returns the main path's launches."""
    from mapping_tpu_torch.utils import native_decode, png, webp

    begin = time.perf_counter()
    manifest = json.loads((WEBP_CORPUS / "manifest.json").read_text())
    decoded, refused = corpus_digests(WEBP_CORPUS,
                                      native_decode.decode_rgb_bytes,
                                      "decode_sha256")
    if (decoded, refused) != (
            sum("refused" not in e for e in manifest.values()),
            sum("refused" in e for e in manifest.values())):
        raise AssertionError(f"the WebP corpus: {decoded} decoded, "
                             f"{refused} refused")
    print(f"webp: (a) {decoded} WebP corpus files decode on the host to the "
          f"JAX package's digests, {refused} refused kinds raise naming "
          f"their cause; (a) took {time.perf_counter() - begin:.2f} s")
    part = time.perf_counter()

    # (b) lossy and lossless WebP tiles against PNG of their decoded pixels
    shutil.rmtree(WEBP_DIR, ignore_errors=True)
    for fmt in ("webp", "png"):
        (WEBP_DIR / fmt).mkdir(parents=True)
    for path in sorted(WEBP_CORPUS.glob("tile300_*.webp")):
        shutil.copy2(path, WEBP_DIR / "webp" / path.name)
        (WEBP_DIR / "png" / f"{path.stem}.png").write_bytes(png.encode_png(
            native_decode.decode_rgb_bytes(path.read_bytes())))
    kinds = {kind: len(list((WEBP_DIR / "webp").glob(f"tile300_{kind}_*")))
             for kind in ("lossy", "lossless")}
    tiles = sum(kinds.values())
    experiment = WEBP_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    config = write_config("webp", {
        "data_dir": str(WEBP_DIR), "meta_dir": str(WEBP_DIR / "meta"),
        "experiment_dir": str(experiment), "device": DEVICE,
        **EVAL_PARAMS}, where=WEBP_DIR)
    runs = {fmt: tiff_predict(config, fmt, WEBP_DIR) for fmt in ("png",
                                                                 "webp")}
    same = (WEBP_DIR / "webp.json").read_bytes() == \
        (WEBP_DIR / "png.json").read_bytes()
    prediction = check_prediction(WEBP_DIR / "webp.json", set(range(tiles)),
                                  "WebP tiles", allow_empty=True)
    seconds, launched, _, timings = runs["webp"]
    if not same or kinds != {"lossy": 8, "lossless": 8} \
            or min(launched.values(), default=0) < 1 \
            or timings["images"] != tiles:
        raise AssertionError(f"predict_on_dir over WebP tiles {kinds}: same "
                             f"as PNG {same}, CCL launches {launched}, "
                             f"{timings['images']} images")
    print(f"webp: (b) predict_on_dir over {kinds['lossy']} lossy and "
          f"{kinds['lossless']} lossless 300^2 WebP tiles wrote the same "
          f"prediction.json as over PNG tiles of their decoded pixels "
          f"({len(prediction)} instances); WebP {seconds:.2f} s, decode_s "
          f"{timings['decode_s']:.4f}, PNG {runs['png'][0]:.2f} s, decode_s "
          f"{runs['png'][3]['decode_s']:.4f} (host clock); CCL launches "
          f"{launched} on {smi}")
    print(f"webp: (b) took {time.perf_counter() - part:.2f} s")

    # (c) the host decode of a 300^2 tile on one thread
    timed = {}
    for what, name in WEBP_TIMED.items():
        data = (WEBP_CORPUS / name).read_bytes()
        webp.decode(data)
        ms = []
        for _ in range(WEBP_REPS):
            start = time.perf_counter()
            webp.decode(data)
            ms.append((time.perf_counter() - start) * 1e3)
        timed[what] = (float(np.median(ms)), min(ms))
    print("webp: (c) host decode of a 300^2 tile on 1 thread, median (min) "
          "ms: " + ", ".join(f"{what} {m:.4f} ({lo:.4f})"
                             for what, (m, lo) in timed.items())
          + f" (host clock, {WEBP_REPS} decodes each) on {smi}")
    seconds = time.perf_counter() - begin
    print(f"webp: phase 18 took {seconds:.2f} s; main-path launches "
          f"{launched}")
    if seconds > WEBP_BUDGET_S:
        raise AssertionError(f"phase 18 took {seconds:.2f} s, over its "
                             f"{WEBP_BUDGET_S} s")
    return launched


def raster_phase(smi):
    """Phase 19: the BMP and GIF corpora through the port's readers,
    predict_on_dir over BMP, DIB and GIF tiles = over the same pixels as
    PNG, and the host decode's ms a tile. Returns the main path's
    launches."""
    from mapping_tpu_torch.utils import bmp, gif, native_decode, png

    begin = time.perf_counter()
    counts = {}
    for kind, corpus in (("BMP", BMP_CORPUS), ("GIF", GIF_CORPUS)):
        manifest = json.loads((corpus / "manifest.json").read_text())
        counts[kind] = corpus_digests(corpus, native_decode.decode_rgb_bytes,
                                      "decode_sha256")
        if counts[kind] != (
                sum("refused" not in e for e in manifest.values()),
                sum("refused" in e for e in manifest.values())):
            raise AssertionError(f"the {kind} corpus: {counts[kind][0]} "
                                 f"decoded, {counts[kind][1]} refused")
    print("raster: (a) " + ", ".join(
        f"{d} {kind} corpus files decode on the host to the JAX package's "
        f"digests, {r} refused kinds raise naming their cause"
        for kind, (d, r) in counts.items())
        + f"; (a) took {time.perf_counter() - begin:.2f} s")
    part = time.perf_counter()

    # (b) BMP, DIB and GIF tiles against PNG of their decoded pixels
    shutil.rmtree(RASTER_DIR, ignore_errors=True)
    for fmt in ("raster", "png"):
        (RASTER_DIR / fmt).mkdir(parents=True)
    tiles = sorted(BMP_CORPUS.glob("tile300_*.bmp")) + sorted(
        GIF_CORPUS.glob("tile300_*.gif"))
    for path in tiles:
        shutil.copy2(path, RASTER_DIR / "raster" / path.name)
    dib = (BMP_CORPUS / "tile300_raw24_1.bmp").read_bytes()[14:]
    (RASTER_DIR / "raster" / "tile300_raw24_1_headerless.dib").write_bytes(
        dib)
    for path in sorted((RASTER_DIR / "raster").iterdir()):
        (RASTER_DIR / "png" / f"{path.name}.png").write_bytes(png.encode_png(
            native_decode.decode_rgb_bytes(path.read_bytes())))
    kinds = {ext: len(list((RASTER_DIR / "raster").glob(f"*.{ext}")))
             for ext in ("bmp", "dib", "gif")}
    n = sum(kinds.values())
    experiment = RASTER_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    config = write_config("raster", {
        "data_dir": str(RASTER_DIR), "meta_dir": str(RASTER_DIR / "meta"),
        "experiment_dir": str(experiment), "device": DEVICE,
        **EVAL_PARAMS}, where=RASTER_DIR)
    runs = {fmt: tiff_predict(config, fmt, RASTER_DIR)
            for fmt in ("png", "raster")}
    same = (RASTER_DIR / "raster.json").read_bytes() == \
        (RASTER_DIR / "png.json").read_bytes()
    prediction = check_prediction(RASTER_DIR / "raster.json", set(range(n)),
                                  "BMP, DIB and GIF tiles", allow_empty=True)
    seconds, launched, _, timings = runs["raster"]
    if not same or kinds != {"bmp": 4, "dib": 1, "gif": 2} \
            or min(launched.values(), default=0) < 1 \
            or timings["images"] != n:
        raise AssertionError(f"predict_on_dir over BMP, DIB and GIF tiles "
                             f"{kinds}: same as PNG {same}, CCL launches "
                             f"{launched}, {timings['images']} images")
    print(f"raster: (b) predict_on_dir over {kinds['bmp']} BMP (2 raw 24-bit, "
          f"2 RLE8), {kinds['dib']} DIB and {kinds['gif']} GIF 300^2 tiles "
          f"wrote the same prediction.json as over PNG tiles of their "
          f"decoded pixels ({len(prediction)} instances); BMP/DIB/GIF "
          f"{seconds:.2f} s, decode_s {timings['decode_s']:.4f}, PNG "
          f"{runs['png'][0]:.2f} s, decode_s "
          f"{runs['png'][3]['decode_s']:.4f} (host clock); CCL launches "
          f"{launched} on {smi}")
    print(f"raster: (b) took {time.perf_counter() - part:.2f} s")

    # (c) the host decode of a 300^2 tile on one thread
    timed = {}
    for what, path in RASTER_TIMED.items():
        data = path.read_bytes()
        decode = gif.decode if path.suffix == ".gif" else bmp.decode
        decode(data)
        ms = []
        for _ in range(RASTER_REPS):
            start = time.perf_counter()
            decode(data)
            ms.append((time.perf_counter() - start) * 1e3)
        timed[what] = (float(np.median(ms)), min(ms))
    print("raster: (c) host decode of a 300^2 tile on 1 thread, median (min) "
          "ms: " + ", ".join(f"{what} {m:.4f} ({lo:.4f})"
                             for what, (m, lo) in timed.items())
          + f" (host clock, {RASTER_REPS} decodes each) on {smi}")
    seconds = time.perf_counter() - begin
    print(f"raster: phase 19 took {seconds:.2f} s; main-path launches "
          f"{launched}")
    if seconds > RASTER_BUDGET_S:
        raise AssertionError(f"phase 19 took {seconds:.2f} s, over its "
                             f"{RASTER_BUDGET_S} s")
    return launched


def jp2_phase(smi):
    """Phase 20: the JPEG 2000 corpus through the port's reader,
    predict_on_dir over JP2 and J2K tiles = over the same pixels as PNG,
    and the host decode's ms a tile beside a JPEG's. Returns the main
    path's launches."""
    from mapping_tpu_torch.utils import jp2, jpeg, native_decode, png

    begin = time.perf_counter()
    manifest = json.loads((JP2_CORPUS / "manifest.json").read_text())
    decoded, refused = corpus_digests(JP2_CORPUS,
                                      native_decode.decode_rgb_bytes,
                                      "decode_sha256")
    if (decoded, refused) != (
            sum("refused" not in e for e in manifest.values()),
            sum("refused" in e for e in manifest.values())):
        raise AssertionError(f"the JPEG 2000 corpus: {decoded} decoded, "
                             f"{refused} refused")
    print(f"jp2: (a) {decoded} JPEG 2000 corpus files decode on the host to "
          f"the JAX package's digests, {refused} refused kinds raise naming "
          f"their cause; (a) took {time.perf_counter() - begin:.2f} s")
    part = time.perf_counter()

    # (b) JP2 and J2K tiles against PNG of their decoded pixels
    shutil.rmtree(JP2_DIR, ignore_errors=True)
    for fmt in ("jp2", "png"):
        (JP2_DIR / fmt).mkdir(parents=True)
    for path in sorted(JP2_CORPUS.glob("tile300_*")):
        shutil.copy2(path, JP2_DIR / "jp2" / path.name)
        (JP2_DIR / "png" / f"{path.stem}.png").write_bytes(png.encode_png(
            native_decode.decode_rgb_bytes(path.read_bytes())))
    kinds = {kind: len(list((JP2_DIR / "jp2").glob(f"tile300_{kind}_*")))
             for kind in ("reversible", "irreversible", "rpcl")}
    tiles = sum(kinds.values())
    experiment = JP2_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    config = write_config("jp2", {
        "data_dir": str(JP2_DIR), "meta_dir": str(JP2_DIR / "meta"),
        "experiment_dir": str(experiment), "device": DEVICE,
        **EVAL_PARAMS}, where=JP2_DIR)
    runs = {fmt: tiff_predict(config, fmt, JP2_DIR) for fmt in ("png",
                                                                "jp2")}
    same = (JP2_DIR / "jp2.json").read_bytes() == \
        (JP2_DIR / "png.json").read_bytes()
    prediction = check_prediction(JP2_DIR / "jp2.json", set(range(tiles)),
                                  "JPEG 2000 tiles", allow_empty=True)
    seconds, launched, _, timings = runs["jp2"]
    if not same or kinds != {"reversible": 3, "irreversible": 3, "rpcl": 3} \
            or min(launched.values(), default=0) < 1 \
            or timings["images"] != tiles:
        raise AssertionError(f"predict_on_dir over JPEG 2000 tiles {kinds}: "
                             f"same as PNG {same}, CCL launches {launched}, "
                             f"{timings['images']} images")
    print(f"jp2: (b) predict_on_dir over {kinds['reversible']} reversible "
          f"JP2, {kinds['irreversible']} irreversible JP2 and "
          f"{kinds['rpcl']} tiled RPCL J2K 300^2 tiles wrote the same "
          f"prediction.json as over PNG tiles of their decoded pixels "
          f"({len(prediction)} instances); JPEG 2000 {seconds:.2f} s, "
          f"decode_s {timings['decode_s']:.4f}, PNG {runs['png'][0]:.2f} s, "
          f"decode_s {runs['png'][3]['decode_s']:.4f} (host clock); CCL "
          f"launches {launched} on {smi}")
    print(f"jp2: (b) took {time.perf_counter() - part:.2f} s")

    # (c) the host decode of a 300^2 tile on one thread, beside a JPEG's
    def median_ms(decode, data):
        decode(data)
        ms = []
        for _ in range(JP2_REPS):
            start = time.perf_counter()
            decode(data)
            ms.append((time.perf_counter() - start) * 1e3)
        return float(np.median(ms)), min(ms)

    timed = {what: median_ms(jp2.decode, (JP2_CORPUS / name).read_bytes())
             for what, name in JP2_TIMED.items()}
    pixels = native_decode.decode_rgb_bytes(
        (JP2_CORPUS / JP2_TIMED["reversible JP2"]).read_bytes())
    baseline = jpeg.encode(pixels, quality=95)
    timed["JPEG Huffman"] = median_ms(jpeg.read, baseline)
    timed["JPEG Huffman + plain pixels on the CPU"] = median_ms(
        native_decode.decode_rgb_bytes, baseline)
    print("jp2: (c) host decode of a 300^2 tile on 1 thread, median (min) "
          "ms: " + ", ".join(f"{what} {m:.4f} ({lo:.4f})"
                             for what, (m, lo) in timed.items())
          + f" (host clock, {JP2_REPS} decodes each; the JPEG at quality "
          f"95, 4:2:0, of the reversible tile's pixels) on {smi}")
    seconds = time.perf_counter() - begin
    print(f"jp2: phase 20 took {seconds:.2f} s; main-path launches "
          f"{launched}")
    if seconds > JP2_BUDGET_S:
        raise AssertionError(f"phase 20 took {seconds:.2f} s, over its "
                             f"{JP2_BUDGET_S} s")
    return launched


def is_lossless_jpeg(name):
    """The lossless (SOF3) files of the JPEG and TIFF corpora, by name."""
    return name.startswith(("lossless", "tile300_lossless", "jpeg_lossless"))


def jpeg_lossless_phase(smi):
    """Phase 21: lossless JPEG, bare and as JPEG-compressed TIFF strips and
    tiles, through the port's host decoder: the corpora's digests and
    refusals (the TIFF files through `assemble` on the card),
    predict_on_dir over 9 lossless tiles = over the same pixels as PNG,
    and a 300^2 tile's host decode beside the JPEG Huffman decode of the
    same pixels. Returns the main path's launches."""
    from mapping_tpu_torch.utils import jpeg, native_decode, png

    begin = time.perf_counter()

    def on_card(data):
        return native_decode.assemble([native_decode.read_bytes(data)],
                                      DEVICE)[0].cpu().numpy()

    found = {}
    for corpus, read in ((JPEG_CORPUS, native_decode.decode_rgb_bytes),
                         (TIFF_CORPUS, on_card)):
        manifest = json.loads((corpus / "manifest.json").read_text())
        picked = [e for n, e in manifest.items() if is_lossless_jpeg(n)]
        found[corpus.name] = corpus_digests(corpus, read, "decode_sha256",
                                            is_lossless_jpeg)
        if found[corpus.name] != (sum("refused" not in e for e in picked),
                                  sum("refused" in e for e in picked)):
            raise AssertionError(f"lossless files of {corpus.name}: "
                                 f"{found[corpus.name]} (decoded, refused)")
    print(f"jpeg_lossless: (a) lossless JPEG files decode on the host to "
          f"the JAX package's digests and the refused kinds raise naming "
          f"their cause: {found['jpeg_corpus']} (decoded, refused) bare, "
          f"{found['tiff_corpus']} as JPEG-compressed TIFF through "
          f"`assemble` on the card; (a) took "
          f"{time.perf_counter() - begin:.2f} s")
    part = time.perf_counter()

    # (b) lossless tiles against PNG of their decoded pixels
    shutil.rmtree(JPEG_LOSSLESS_DIR, ignore_errors=True)
    for fmt in ("jpeg", "png"):
        (JPEG_LOSSLESS_DIR / fmt).mkdir(parents=True)
    tiles = sorted(JPEG_CORPUS.glob("tile300_lossless_*.jpg"))
    for path in tiles:
        shutil.copy2(path, JPEG_LOSSLESS_DIR / "jpeg" / path.name)
        pixels = native_decode.decode_rgb_bytes(path.read_bytes())
        (JPEG_LOSSLESS_DIR / "png" / f"{path.stem}.png").write_bytes(
            png.encode_png(pixels))
    experiment = JPEG_LOSSLESS_DIR / "experiment"
    (experiment / "transformers").mkdir(parents=True)
    shutil.copy2(TRAIN_DIR / "full" / "transformers" / "unet.pt",
                 experiment / "transformers" / "unet.pt")
    config = write_config("jpeg_lossless", {
        "data_dir": str(JPEG_LOSSLESS_DIR),
        "meta_dir": str(JPEG_LOSSLESS_DIR / "meta"),
        "experiment_dir": str(experiment), "device": DEVICE,
        **EVAL_PARAMS}, where=JPEG_LOSSLESS_DIR)
    runs = {fmt: tiff_predict(config, fmt, JPEG_LOSSLESS_DIR)
            for fmt in ("png", "jpeg")}
    same = (JPEG_LOSSLESS_DIR / "jpeg.json").read_bytes() == \
        (JPEG_LOSSLESS_DIR / "png.json").read_bytes()
    prediction = check_prediction(JPEG_LOSSLESS_DIR / "jpeg.json",
                                  set(range(len(tiles))),
                                  "lossless JPEG tiles", allow_empty=True)
    seconds, launched, pixels_launched, timings = runs["jpeg"]
    if not same or len(tiles) != 9 or pixels_launched \
            or launched != {"ccl_label_raw": 1, "ccl_renumber": 1} \
            or timings["images"] != len(tiles):
        raise AssertionError(f"predict_on_dir over {len(tiles)} lossless "
                             f"JPEG tiles: same as PNG {same}, CCL launches "
                             f"{launched}, jpeg_pixels {pixels_launched}, "
                             f"{timings['images']} images")
    print(f"jpeg_lossless: (b) predict_on_dir over {len(tiles)} lossless "
          f"300^2 JPEG tiles (RGB, predictor 1, Pt 0) wrote the same "
          f"prediction.json as over PNG tiles of their decoded pixels "
          f"({len(prediction)} instances); lossless JPEG {seconds:.2f} s, "
          f"decode_s {timings['decode_s']:.4f}, PNG {runs['png'][0]:.2f} s, "
          f"decode_s {runs['png'][3]['decode_s']:.4f} (host clock); CCL "
          f"launches {launched}, jpeg_pixels {pixels_launched} on {smi}")
    print(f"jpeg_lossless: (b) took {time.perf_counter() - part:.2f} s")

    # (c) the host decode of a 300^2 tile on one thread, beside a JPEG's
    def median_ms(decode, data):
        decode(data)
        ms = []
        for _ in range(JPEG_LOSSLESS_REPS):
            start = time.perf_counter()
            decode(data)
            ms.append((time.perf_counter() - start) * 1e3)
        return float(np.median(ms)), min(ms)

    data = tiles[0].read_bytes()
    timed = {"lossless JPEG": median_ms(jpeg.read, data)}
    baseline = jpeg.encode(jpeg.read(data), quality=95)
    timed["JPEG Huffman"] = median_ms(jpeg.read, baseline)
    print("jpeg_lossless: (c) host decode of a 300^2 tile on 1 thread, "
          "median (min) ms: " + ", ".join(f"{what} {m:.4f} ({lo:.4f})"
                                          for what, (m, lo) in timed.items())
          + f" (host clock, {JPEG_LOSSLESS_REPS} decodes each; the JPEG at "
          f"quality 95, 4:2:0, of the same pixels) on {smi}")
    seconds = time.perf_counter() - begin
    print(f"jpeg_lossless: phase 21 took {seconds:.2f} s; main-path "
          f"launches {launched}")
    if seconds > JPEG_LOSSLESS_BUDGET_S:
        raise AssertionError(f"phase 21 took {seconds:.2f} s, over its "
                             f"{JPEG_LOSSLESS_BUDGET_S} s")
    return launched


def main():
    start = time.perf_counter()
    last = [start]

    def lap(phase):
        """Prints the phase's seconds and the script's so far."""
        now = time.perf_counter()
        print(f"timing: phases to {phase} took {now - last[0]:.1f} s, "
              f"{now - start:.1f} s since the start")
        last[0] = now

    smi = card()
    from mapping_tpu_torch.kernels import bounds

    build_phase()
    gen = torch.Generator().manual_seed(0)
    err, times = kernel_phase(gen)
    launches = slice_phase(gen, smi)
    err["conv_dw"], times["conv_dw"] = conv_dw_phase()
    lap(5)
    prepared = prepare_phase(smi)
    lap(6)
    launches["conv_dw"] = train_phase(gen, smi, prepared)["conv_dw"]
    lap(7)
    evaluated, png_run = evaluate_phase(gen, smi)
    lap(8)
    phases = ((9, lambda: train_cli_phase(smi, prepared)),
              (10, lambda: scoring_phase(smi, prepared)),
              (11, lambda: serving_phase(smi, prepared)),
              (12, lambda: zoo_phase(smi, prepared)),
              (13, lambda: quantize_phase(gen, smi, prepared)),
              (14, lambda: parallel_phase(smi, prepared)),
              (15, lambda: spatial_phase(smi, prepared)))
    counted = [prepared["launches"], evaluated]
    for number, phase in phases:
        counted.append(phase())
        lap(number)
    jpeg_err, jpeg_times, jpeg_launches, bound = jpeg_phase(smi, png_run)
    lap(16)
    tiff_launches, tiff_err = tiff_phase(smi)
    counted.append(tiff_launches)
    lap(17)
    counted.append(webp_phase(smi))
    lap(18)
    counted.append(raster_phase(smi))
    lap(19)
    counted.append(jp2_phase(smi))
    lap(20)
    counted.append(jpeg_lossless_phase(smi))
    lap(21)
    for counts in counted + [jpeg_launches]:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    err.update({name: max(e, tiff_err.get(name, 0))
                for name, e in jpeg_err.items()})
    times.update(jpeg_times)
    n, c, h, w = DW_TIMED[DW_MAIN]
    bound.update({"ccl_label_raw": bounds.ccl_label_raw(BATCH, TILE, TILE),
                  "ccl_renumber": bounds.ccl_renumber(BATCH, TILE, TILE),
                  "conv_dw": bounds.conv_dw(n, c, h, w, 3)})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": times[name][2]}
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
