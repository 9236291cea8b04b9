#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (imageencoder_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 9   # the build, then phase 9 alone

It needs one CUDA card (an H100: the kernels are built for sm_90a), nvcc,
and this checkout.  It imports only the port, which stands alone: JAX and
the JAX package (imageencoder_tpu) are blocked before anything is
imported.  It drives these paths: the image encode (encode_image), the
video encode (encode_video) with the raw and with the recon motion
reference, the image decode (decode_image), the video decode
(decode_frames and decode_video), the serving paths (encode_image_batch,
encode_image_stream, decode_image_batch) and the command line (python -m
imageencoder_tpu_torch, checkpointed video encode included) and the
sharded and multi-process paths (imageencoder_tpu_torch.parallel).  Phases,
each of which raises on failure:

  1. build the kernels in imageencoder_tpu_torch/csrc with nvcc, one
     process per source, all started together;
  2. capture the arguments each kernel wrapper receives in one real call
     of each path, and hold every kernel the path runs against its plain
     PyTorch version on those CUDA tensors, bit-equal: encode_image on a
     4096x912 image (233,472 blocks) for K1 encode_locals (u8 pixels), K2
     pack_locals+hist (K2 with K3 folded in: the stream and its byte
     histogram), the Huffman dict kernel (csrc/huffman.cu: the codes, the
     dict and the totals from the histogram) and K4 pack_payload (the
     Huffman payload under the dict's table, on K2's two launches, its
     row their sum), K2 pack_locals alone on the
     same records; the dict kernel also on the histogram of a small noise
     image that takes the raw-copy fallback; encode_video at 1280x720, 25
     frames, gop 4, merange 16, Huffman on, with the raw reference for
     K6+K7 search_residual (the search with the prediction as its
     epilogue, the whole video in, held against the plain search,
     prediction and residual), K1 on the int16 residual stack, K2 with its
     vector source (with and without the histogram), the dict and K4
     pack_payload; and with the recon reference, stepped by GOP, for its
     K5 quantize_image call (the 7 I-frames in one launch, a view of every
     gop-th frame) and its 3 K5 recon_step (the fused P-frame step) and
     K6+K7 search_predict calls (frame k of every GOP, views too), with
     the record lengths K5 and the step write, K4 pack_coeffs+hist (launch
     1 sums those lengths, launch 2 packs the records from the
     coefficients and the vectors and counts their byte histogram),
     pack_coeffs alone, and again from the coefficients' own lengths, the
     dict and K4 pack_payload; encode_video at 320x176 with 40 frames,
     forced into two chunks spliced on the host (a card's frame budget
     would take it in one pass), for K3 byte_histogram alone
     (the only path left that runs it) and the dict on its histogram; the
     kernels no path runs on inputs taken from those calls: K6
     motion_search and K7 predict (the search and the prediction alone) on
     the frames and the vectors of both video paths, K4 pack_records on
     the recon records as fields built by the plain glue; decode_image of
     the 4096x912 Huffman stream written on the card for D1
     huffman_decode, D2 walk_offsets and D3 decode_blocks (D1's payload
     compared up to its byte count), and for D1 and D2 their stats
     (cuda_decode.CHAIN_STATS: chunks, chunks walked whole, what D2's
     sweep did, the rounds that changed a chunk, whether a break was left
     after them; D1 must take the rounds alone on one of the image and
     720p25 streams and its table on the other, each held bit-equal);
     decode_frames of the 720p25 raw stream for
     D1 on a video's payload, D2 walk_video (one chain over the whole
     video), the vector read, every D3 call (the I-frames, then frame k of
     every GOP onto its prediction) and every K7 predict call (frame k
     predicted from frame k - 1 at the vectors read from the stream);
     encode_image_batch of 16 seeded 4096x912 images (the last one noise)
     for K1 on the stacked images and the batched K2 (with and without
     the histograms), dict kernel and K4 pack_payload (a batch's stream
     the grid's y; K4 on K2's two launches, its row their sum), and of 4
     128x256 images under quant all ones, whose noise image takes the
     raw-copy fallback inside the batch, for the batched K2, dict and K4
     again; the dict kernel, one stream and a batch, on adversarial
     histograms (Fibonacci and power-of-two chains, merged serially and
     in rounds, through the 15-bit limit; geometric counts up to 2^30;
     ties; two, one and no byte values; all 256 equal; a refused stream);
     D3 on the 4096x912 image's records with its payload cut to two
     thirds (reads past the byte count are zero) and with the payload 3
     bytes past a 16-byte boundary, and on a 4096x912 noise image in 8x8
     blocks under quant all ones without RLE (64 wide fields a record,
     its own row); the wire emit (csrc/wire.cu: every encode's final
     streams as wire-order bytes on the card, the raw-copy fallback's
     one 0 bit and one-bit shift included) on the tails of the image
     (Huffman on; the small noise image, which falls back; a full-size
     fallback, a seeded random inner stream of the 4096x912 image's
     Huffman stream size through huffman.huffman_encode, since no
     full-size image falls back), the raw and recon video,
     the 40-frame video's chunks and stream, both batches (the small one
     mixes coded and fallback streams), the stream of 16, a checkpointed
     320x176x8 encode and, in phase 9, the sharded paths, its buffer
     compared up to its last stream's padded end.  The packers' words are
     compared up to each stream's last word, which is all the kernels
     define.  K3 is also timed against torch.bincount over the same
     stream bytes, and the emit against torch.flip of its source words
     as bytes (the byte swap alone), the PyTorch calls that compute their
     functions;
  3. from here on device_pack.words_to_bytes and huffman._fallback, the
     host serialization the emit replaced, raise wherever the port binds
     them (in the spawned processes of phase 9 too; the CLI's
     subprocesses of phase 8 excepted): every path below runs without
     them.  Drive each path with every kernel's launch count set to 0 just
     before it and read just after: encode_image(..., device="cuda") on
     seeded 4096x912 and 3840x2160 images with Huffman on and off and on
     a small noise image that takes the raw-copy fallback; encode_video at
     720p25 with Huffman on and off, raw and recon; the 40-frame video;
     decode_image(..., device="cuda") of every image stream; and
     decode_frames(..., device="cuda") of the four 720p25 streams and the
     40-frame one.  Every kernel a path runs must have been launched at
     least once in that path's run, no path but the long video's may
     launch K3, and no encode path may launch K6 or K7 alone (no path
     launches K6 alone).  One encode_image with Huffman on must launch K1,
     K2+hist, the dict, K4 pack_payload and the emit once each and
     nothing else; one 720p25 recon encode_video at gop 4, Huffman on, K5
     once, the search and the recon step 3 times each (7 launches before
     the pack), K4 pack_coeffs+hist, the dict, K4 pack_payload and the
     emit once each, and nothing else.
     No encode path may launch a decode kernel, and a decode path
     launches its own kernels only: the image decode D1 once a Huffman
     stream, D2 and D3 once a stream; the video decode D1 once a Huffman
     stream, D2 walk_video and the vector read once a stream, D3 once and
     K7 alone once less a GOP step (min(gop, frames)): at gop 4, 4 and 3
     whatever the frame count; encode_image_batch at B = 16 (4096x912)
     and B = 8 (3840x2160), Huffman on and off: each call launches K1,
     the batched K2 and, with Huffman, the batched dict and K4 once each
     and nothing else; encode_image_stream of the 16 images at depth 2
     (the single-image kernels, 16 launches each); decode_image_batch of
     the 16 Huffman streams (D1, D2, D3, 16 each, no encode kernel);
  4. hold every image stream from phase 3, and its pixels decoded on the
     card, video streams of both
     references at 320x176 with 8 frames (gop 4, merange 16, Huffman on and
     off), the 40-frame video's, and the frames phase 3 decoded on the card
     from the video streams (and those of decode_video with and without
     motion compensation), against the port's plain path, device="cpu",
     byte for byte; the same for every stream of the four batch calls
     (the plain path's encode_image_batch, stream by stream), the
     stream's 16 (equal to the batch's) and the 16 images
     decode_image_batch left on the card (each equal to the plain
     decode_image).
     That path is the one tests/test_torch_image.py and
     tests/test_torch_video.py hold byte-equal to the JAX package's host
     engine; tests/test_torch_cuda.py holds the card's full-size image and
     720p25 video streams against that engine on the card;
  5. the division sweep: K1's reciprocal division beside __ddiv_rn for
     every quant q in 1..255, around every quotient k, k + 1/2 and k + 1/4
     within the residual coefficient bound (8 ulps each way) and for 10^7
     seeded random y (csrc/division.cu); any mismatch fails;
  6. time, inputs resident on the device: the device encode, the Huffman
     stage (the dict kernel, K4 pack_payload, the one wait and the copies),
     the whole encode_image and the host-to-device copy of the image; for
     the video decode of the 720p25 raw stream, the host's parse, the
     stream's upload, the device window (D1, D2, the vector read, D3 and
     K7), decode_frames until its frames are ready and decode_video with
     its copy of the YUV420 frames to the host; for
     video, the whole encode_video of frames on the device, the device
     window (K6+K7 + K1 + K2, or K5 on the I-frames, per GOP step K6+K7
     and the recon step, then K4 pack_coeffs's two launches, until the
     histogram is counted),
     the Huffman stage and the copy of the frames; for the decode of the
     4096x912 and 3840x2160 Huffman streams, the host's parse, the
     stream's upload, the device window (D1-D3) and the whole decode_image
     until its pixels are ready; for serving, on the 16 4096x912 images
     on the device, encode_image_batch, 16 back-to-back encode_image
     calls, encode_image_stream and decode_image_batch of the batch's
     streams, each with its Mpix/s; for the image and the batch, the
     tail's host ms split into its launch, its copy (the lengths' wait and
     the one copy) and its bytes (the copy's wait and one bytes a
     stream);
  7. profile a few calls of each path and print the device time per call
     by operation and the device operations per call: where the device
     time goes.  A video profile with a row of K7 alone, or a raw one with
     a scan row (a cumsum of record lengths), fails.  For each Huffman-on
     path, the device-to-host copies a call (profiler rows) and the host's
     waits for the device a call (PyTorch's sync debug mode counts each
     one): one of each is the stream's own copy, and the path fails with
     more than one wait before it or with more than two copies (its
     lengths', then its bytes' one copy, whatever the batch; the stream
     two an image).  A decode_image or decode_frames that
     waits on the device at all fails: it leaves its pixels there; a
     decode_video waits once, for its frames' copy.  A wait on an event
     is counted too (the debug mode does not see it): encode_image_batch
     waits at most twice whatever B (its lengths, then its copy),
     encode_image_stream at most once an image and once at its end, and
     decode_image_batch never;
  8. the command line: python -m imageencoder_tpu_torch as a subprocess
     with --device cuda on a 4096x912 image job, a 320x176x8 video
     encoder job with a decoder's decfile, and the same video with
     --checkpoint-dir, run again from the directory a run stopped after
     its first GOP leaves; exit codes 0, and every file equal to what the
     CLI writes with --device cpu in this process;
  9. the sharded and multi-process paths (imageencoder_tpu_torch/
     parallel): in a world of one over NCCL, encode_sharded_image_batch
     of the serving batch with Huffman after stage 1 (K1, K2 over
     segments, K3 over each spliced stream, the batched dict and K4) and
     by the distributed stage 2 (K1, K2 over segments, K3 over the
     segments' whole bytes and over their owned bytes, the batched dict,
     K4 over byte windows), every kernel call held against its plain
     version and every stream equal to the one-device batch's; then
     decode_image_sharded of the 3840x2160 stream (D1, D2, D3 on the
     stripe), pixel-equal to decode_image; then the GOP-distributed
     encode_video of the 720p25 video (raw and recon) and of the 320x176
     one in two gloo processes on the card, every kernel call of one
     encode in each process held against its plain version (K3 alone on
     the spliced 720p25 stream among them), each stream equal to the
     one-process encode_video's (the small one to the plain path's); each
     path's launches counted from 0, and medians, device and host
     profiles and waits of each call.  Then the sharded video
     (parallel/video_sharding.py): in the world of one,
     encode_video_sharded of the 720p25 video, raw and recon, Huffman on
     and off (K6+K7 on the stripe, search_residual_stripe, or in recon
     mode search_predict_stripe and the recon step once a GOP step over
     frame k of every GOP, 3 of each at gop 4, into the carry's haloed
     buffer; K1; K2 over the block segments and K4 pack_records over the
     vector segments; with Huffman the windowed K3 over the spliced
     stream, the dict and K4), every stream equal to the one-device
     encode_frames, every kernel call of one encode held against its
     plain version (the strided outputs on buffers of the same strides),
     one recon call's launches checked, and
     decode_video_sharded of the streams, motion compensation on and off,
     equal to decode_video, with medians, p90s, profiles and waits beside
     the one-device calls; and in two gloo processes on the card, a
     (1, 2) mesh whose halo exchange crosses the processes (once a GOP
     step in recon mode), the 1280x704 24-frame video, raw and recon,
     equal to the one-process encode, with each process's recon launches
     checked and its device operations a call printed.
     ``--phase 9`` runs the build and this phase alone, on inputs made by
     the same builders.

Kernel times: ``ms`` and ``plain_ms`` are device time per call from
torch.profiler (the kernel alone; everything the plain version runs);
``stage_ms`` is everything the wrapper runs on the device (the kernel and
its glue: scratch zeroing);
``call_ms`` and ``plain_call_ms`` are CUDA-event times of back-to-back
calls, which include the wrappers' glue and launch overhead.  K7's ``ms``
is taken with the L2 flushed before each call (on its paths it reads
frames just written; ``l2_warm_ms`` is the time without the flush).
``bound_ms`` is the larger of the HBM floor (the bytes the function must
move at 3.35 TB/s) and the operation floor (f64 transforms: their
separately rounded f64 ops at 64 an SM a clock; K6: its byte SADs, 4 to a
__vsadu4 lane op at 64 int32 ops an SM a clock; the fused kernels the
same), both at the H100 SXM's
132 SMs and 1.98 GHz boost clock.  ``library_ms`` is the profiler's
device time of one PyTorch call computing the same function, where one
exists (K3: torch.bincount), else null.  The dict kernel's bound counts
its bytes (the histogram in, the table out); its time is the latency of
a serial merge, which no bound of bytes or operations at the card's peak
rates describes.  D1 counts the stream and its decode table in and the
payload out; D2 the payload in and 16 bytes a record out (over a video
also 16 bytes a frame); the vector read the vectors' bits in, 8 bytes a
frame's start bit and 4 bytes a field out; D3 the larger of its f64 ops
(544 a 4x4 block, 16 more with a prediction) and its bytes (the fields'
bits, 16 bytes a record, the prediction, the pixels).

Output: the card's name and power limit on an early line, one JSON line
{"kernels": [...]} before the last, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time

sys.modules["jax"] = None  # any import of JAX fails loudly
sys.modules["imageencoder_tpu"] = None  # and of the JAX package

QUANT = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]  # top-left of the JPEG luminance table
SHAPES = ((912, 4096), (2160, 3840))  # (H, W): ex4's geometry, 4K UHD
VIDEO = (1280, 720, 25)  # W, H, frames: bench.py's video size
VIDEO_SMALL = (320, 176, 8)  # held against the plain path on the host
VIDEO_LONG = (320, 176, 40)  # two chunks: K3 on the spliced stream
BATCHES = ((16, 912, 4096), (8, 2160, 3840))  # serving: B, H, W
FALLBACK_BATCH = (4, 128, 256)  # 3 smooth images and a noise image
FULL_FALLBACK_BYTES = 2_637_546  # the 4096x912 image's Huffman stream
STREAM_DEPTH = 2
SERVING_SAMPLES = 20  # per serving timing (16 images a sample)
GOP, MERANGE = 4, 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SMS, BOOST_HZ = 132, 1.98e9  # H100 SXM
F64_OPS_PER_S = 64 * SMS * BOOST_HZ  # separately rounded f64 ops
INT32_OPS_PER_S = 64 * SMS * BOOST_HZ  # 32-bit integer lane ops
SAMPLES = 110  # per end-to-end timing: p90 has 11 samples beyond it
VIDEO_SAMPLES = 30  # per video timing: p90 has 3 samples beyond it
PROFILE_CALLS = 10
ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "stage_ms", "call_ms",
            "plain_call_ms", "bytes", "ops", "hbm_floor_ms", "bound_ms",
            "bound_by", "library_ms")  # of a kernel's row at another shape
DIV_RANDOM = 10_000_000  # random y of the division sweep, each over q 1..255
VIDEO_PROFILE_CALLS = 3
KERNELS = {  # name: (wrapper's module, wrapper, plain version,
    #                 CUDA kernel symbol(s), source, the TPU kernel replaced)
    "K1 encode_locals": ("cuda_encode", "encode_locals",
                         "encode_locals_plain", "encode_locals_kernel",
                         "imageencoder_tpu_torch/csrc/encode.cu",
                         "imageencoder_tpu/ops/pallas_encode.py:130"),
    "K2 pack_locals": ("cuda_pack", "pack_locals", "pack_locals_plain",
                       ("tile_sums_kernel", "pack_known_kernel"),
                       "imageencoder_tpu_torch/csrc/pack.cu",
                       "imageencoder_tpu/ops/pallas_pack.py:256"),
    # K2 with K3 folded in: the two launches count the stream's bytes.
    "K2 pack_locals+hist": ("cuda_pack", "pack_locals_hist",
                            "pack_locals_hist_plain",
                            ("tile_sums_kernel", "pack_known_kernel"),
                            "imageencoder_tpu_torch/csrc/pack.cu",
                            "imageencoder_tpu/ops/pallas_pack.py:256"),
    "K3 byte_histogram": ("cuda_kernels", "byte_histogram",
                          "byte_histogram_plain", "byte_histogram_kernel",
                          "imageencoder_tpu_torch/csrc/histogram.cu",
                          "imageencoder_tpu/ops/pallas_kernels.py:37"),
    # No TPU kernel: the host dict build between K3 and K4 in the JAX
    # package (its _dict_and_codes), now a kernel.
    "Huffman dict": ("huffman", "build_dict", "build_dict_plain",
                     "huffman_dict_kernel",
                     "imageencoder_tpu_torch/csrc/huffman.cu",
                     "imageencoder_tpu/ops/huffman.py:194"),
    "K4 pack_records": ("cuda_pack", "pack_records", "pack_records_plain",
                        ("tile_sums_kernel", "pack_known_kernel"),
                        "imageencoder_tpu_torch/csrc/pack.cu",
                        "imageencoder_tpu/ops/pallas_pack.py:55"),
    "K4 pack_payload": ("cuda_pack", "pack_payload", "pack_payload_plain",
                        ("tile_sums_kernel", "pack_known_kernel"),
                        "imageencoder_tpu_torch/csrc/pack.cu",
                        "imageencoder_tpu/ops/pallas_pack.py:55"),
    # On K2's two launches: the lengths K5 and the recon step
    # wrote are summed, then the records packed.
    "K4 pack_coeffs": ("cuda_pack", "pack_coeffs", "pack_coeffs_plain",
                       ("tile_sums_kernel", "pack_known_kernel"),
                       "imageencoder_tpu_torch/csrc/pack.cu",
                       "imageencoder_tpu/ops/pallas_pack.py:55"),
    "K4 pack_coeffs+hist": ("cuda_pack", "pack_coeffs_hist",
                            "pack_coeffs_hist_plain",
                            ("tile_sums_kernel", "pack_known_kernel"),
                            "imageencoder_tpu_torch/csrc/pack.cu",
                            "imageencoder_tpu/ops/pallas_pack.py:55"),
    "K5 quantize_image": ("cuda_encode", "quantize_image",
                          "quantize_image_plain", "quantize_image_kernel",
                          "imageencoder_tpu_torch/csrc/transform.cu",
                          "imageencoder_tpu/ops/pallas_kernels.py:114"),
    "K5 recon_step": ("cuda_encode", "recon_step", "recon_step_plain",
                      "recon_step_kernel",
                      "imageencoder_tpu_torch/csrc/transform.cu",
                      "imageencoder_tpu/ops/pallas_kernels.py:114"),
    "K6 motion_search": ("cuda_motion", "motion_search",
                         "motion_search_plain", "motion_search_kernel",
                         "imageencoder_tpu_torch/csrc/motion.cu",
                         "imageencoder_tpu/ops/pallas_motion.py:38"),
    "K7 predict": ("cuda_motion", "predict", "predict_plain",
                   "predict_kernel", "imageencoder_tpu_torch/csrc/motion.cu",
                   "imageencoder_tpu/ops/pallas_motion.py:160"),
    # The search with the prediction as its epilogue, one launch for both
    # TPU kernels (pallas_motion.py:38 and :160).
    "K6+K7 search_predict": ("cuda_motion", "search_predict",
                             "search_predict_plain", "motion_search_kernel",
                             "imageencoder_tpu_torch/csrc/motion.cu",
                             "imageencoder_tpu/ops/pallas_motion.py:38"),
    "K6+K7 search_residual": ("cuda_motion", "search_residual",
                              "search_residual_plain",
                              "motion_search_kernel",
                              "imageencoder_tpu_torch/csrc/motion.cu",
                              "imageencoder_tpu/ops/pallas_motion.py:38"),
    # The decode: no TPU kernel; each replaces the JAX package's host
    # function of its native engine (D1: walk, check, the rounds, the
    # table of entry offsets with its top and apply, stitch, emit; D2:
    # walk, check, stitch, emit).
    "D1 huffman_decode": ("cuda_decode", "huffman_decode",
                          "huffman_decode_plain",
                          ("huffman_walk_kernel", "huffman_check_kernel",
                           "huffman_round_kernel", "huffman_table_kernel",
                           "huffman_table_top_kernel",
                           "huffman_table_apply_kernel",
                           "huffman_stitch_kernel", "huffman_emit_kernel"),
                          "imageencoder_tpu_torch/csrc/huffman_decode.cu",
                          "imageencoder_tpu/runtime/native/runtime.cpp:1227"),
    "D2 walk_offsets": ("cuda_decode", "walk_offsets", "walk_offsets_plain",
                        ("offset_walk_kernel", "offset_check_kernel",
                         "offset_stitch_kernel", "offset_emit_kernel"),
                        "imageencoder_tpu_torch/csrc/walk.cu",
                        "imageencoder_tpu/runtime/native/runtime.cpp:956"),
    "D3 decode_blocks": ("cuda_decode", "decode_blocks",
                         "decode_blocks_plain", "decode_blocks_kernel",
                         "imageencoder_tpu_torch/csrc/decode.cu",
                         "imageencoder_tpu/runtime/native/runtime.cpp:2219"),
    # D2 over a whole video: the host walks each frame from the bit after
    # the vectors (models/video.py:507-550, runtime.cpp:956 a frame).
    "D2 walk_video": ("cuda_decode", "walk_video", "walk_video_plain",
                      ("offset_walk_kernel", "offset_check_kernel",
                       "offset_stitch_kernel", "offset_emit_kernel"),
                      "imageencoder_tpu_torch/csrc/walk.cu",
                      "imageencoder_tpu/runtime/native/runtime.cpp:956"),
    "vector read": ("cuda_decode", "read_vectors", "read_vectors_plain",
                    "read_vectors_kernel",
                    "imageencoder_tpu_torch/csrc/walk.cu",
                    "imageencoder_tpu/runtime/native/runtime.cpp:1472"),
    # Serving: the same kernels over a batch of streams, the stream the
    # grid's y (K2's two launches, the dict a CTA a stream, K4 pack_payload
    # on K2's two launches).
    "K2 pack_locals batch": ("cuda_pack", "pack_locals_batch",
                             "pack_locals_batch_plain",
                             ("tile_sums_kernel", "pack_known_kernel"),
                             "imageencoder_tpu_torch/csrc/pack.cu",
                             "imageencoder_tpu/ops/pallas_pack.py:256"),
    "K2 pack_locals+hist batch": ("cuda_pack", "pack_locals_hist_batch",
                                  "pack_locals_hist_batch_plain",
                                  ("tile_sums_kernel", "pack_known_kernel"),
                                  "imageencoder_tpu_torch/csrc/pack.cu",
                                  "imageencoder_tpu/ops/pallas_pack.py:256"),
    "Huffman dict batch": ("huffman", "build_dict_batch",
                           "build_dict_batch_plain", "huffman_dict_kernel",
                           "imageencoder_tpu_torch/csrc/huffman.cu",
                           "imageencoder_tpu/ops/huffman.py:194"),
    "K4 pack_payload batch": ("cuda_pack", "pack_payload_batch",
                              "pack_payload_batch_plain",
                              ("tile_sums_kernel", "pack_known_kernel"),
                              "imageencoder_tpu_torch/csrc/pack.cu",
                              "imageencoder_tpu/ops/pallas_pack.py:55"),
    # The sharded paths (parallel/sharding.py): K2 over a rank's segments,
    # each from its own bit phase (the JAX package's TPU branch packs with
    # pack_locals_pallas); K3 over a window of each segment's bytes (its
    # _segment_byte_histogram, an XLA reduction; the owned bytes'
    # histogram that gives stage 2 its code bits; and after stage 1 each
    # spliced stream's whole histogram for the dict); K4 pack_payload over
    # each segment's owned bytes at its output bit (its pack_blocks_device,
    # pack_records_pallas on a TPU).
    "K2 pack_segments": ("cuda_pack", "pack_segments", "pack_segments_plain",
                         ("tile_sums_kernel", "pack_known_kernel"),
                         "imageencoder_tpu_torch/csrc/pack.cu",
                         "imageencoder_tpu/ops/pallas_pack.py:256"),
    "K3 byte_histogram_rows": ("cuda_kernels", "byte_histogram_rows",
                               "byte_histogram_rows_plain",
                               "byte_histogram_rows_kernel",
                               "imageencoder_tpu_torch/csrc/histogram.cu",
                               "imageencoder_tpu/ops/pallas_kernels.py:37"),
    "K4 pack_payload window": ("cuda_pack", "pack_payload_window",
                               "pack_payload_batch_plain",
                               ("tile_sums_kernel", "pack_known_kernel"),
                               "imageencoder_tpu_torch/csrc/pack.cu",
                               "imageencoder_tpu/ops/pallas_pack.py:55"),
    # The sharded video (parallel/video_sharding.py): the search with the
    # prediction as its epilogue on a haloed stripe, clamped in global
    # rows (the JAX package's sharded step runs an XLA SAD scan there,
    # :160-186 and :367-373, where its one-device path runs K6 and K7);
    # K4 pack_records over a rank's vector segments, each from its own bit
    # phase (its pack_blocks_device, pack_records_pallas on a TPU).
    "K6+K7 search_residual_stripe": ("cuda_motion", "search_residual_stripe",
                                     "search_residual_stripe_plain",
                                     "motion_search_kernel",
                                     "imageencoder_tpu_torch/csrc/motion.cu",
                                     "imageencoder_tpu/ops/pallas_motion.py"
                                     ":38"),
    "K6+K7 search_predict_stripe": ("cuda_motion", "search_predict_stripe",
                                    "search_predict_stripe_plain",
                                    "motion_search_kernel",
                                    "imageencoder_tpu_torch/csrc/motion.cu",
                                    "imageencoder_tpu/ops/pallas_motion.py"
                                    ":38"),
    "K4 pack_records segments": ("cuda_pack", "pack_records_segments",
                                 "pack_records_segments_plain",
                                 ("tile_sums_kernel", "pack_known_kernel"),
                                 "imageencoder_tpu_torch/csrc/pack.cu",
                                 "imageencoder_tpu/ops/pallas_pack.py:55"),
    # No TPU kernel: the JAX package's host serialization of the final
    # stream (words_to_bytes, and _fallback where the stream falls back),
    # now a kernel that writes wire-order bytes, every encode path's last.
    "wire emit": ("cuda_pack", "emit_wire", "emit_wire_plain",
                  "emit_wire_kernel", "imageencoder_tpu_torch/csrc/wire.cu",
                  "imageencoder_tpu/ops/device_pack.py:261 and "
                  "imageencoder_tpu/ops/huffman.py:295"),
}
PATHS = {  # path: the kernels it runs (Huffman on and off)
    "image": ("K1 encode_locals", "K2 pack_locals", "K2 pack_locals+hist",
              "Huffman dict", "K4 pack_payload", "wire emit"),
    "video raw": ("K1 encode_locals", "K2 pack_locals", "K2 pack_locals+hist",
                  "Huffman dict", "K4 pack_payload", "K6+K7 search_residual",
                  "wire emit"),
    "video recon": ("K4 pack_coeffs", "K4 pack_coeffs+hist", "Huffman dict",
                    "K4 pack_payload", "K5 quantize_image", "K5 recon_step",
                    "K6+K7 search_predict", "wire emit"),
    "video long": ("K1 encode_locals", "K2 pack_locals", "K3 byte_histogram",
                   "Huffman dict", "K4 pack_payload",
                   "K6+K7 search_residual", "wire emit"),
    "image decode": ("D1 huffman_decode", "D2 walk_offsets",
                     "D3 decode_blocks"),
    "video decode": ("D1 huffman_decode", "D2 walk_video", "vector read",
                     "D3 decode_blocks", "K7 predict"),
    "image batch": ("K1 encode_locals", "K2 pack_locals batch",
                    "K2 pack_locals+hist batch", "Huffman dict batch",
                    "K4 pack_payload batch", "wire emit"),
    "image stream": ("K1 encode_locals", "K2 pack_locals+hist",
                     "Huffman dict", "K4 pack_payload", "wire emit"),
    "image batch decode": ("D1 huffman_decode", "D2 walk_offsets",
                           "D3 decode_blocks"),
    # Phase 9: a world of one over NCCL; the GOP encode in two processes.
    "sharded image": ("K1 encode_locals", "K2 pack_segments",
                      "K3 byte_histogram_rows", "Huffman dict batch",
                      "K4 pack_payload batch", "wire emit"),
    "sharded image stage 2": ("K1 encode_locals", "K2 pack_segments",
                              "K3 byte_histogram_rows", "Huffman dict batch",
                              "K4 pack_payload window", "wire emit"),
    "sharded decode": ("D1 huffman_decode", "D2 walk_offsets",
                       "D3 decode_blocks"),
    # Each GOP's payload from bit 0, then the spliced stream's Huffman
    # stage: K3 alone counts it.
    "gop encode raw": ("K1 encode_locals", "K2 pack_locals",
                       "K6+K7 search_residual", "K3 byte_histogram",
                       "Huffman dict", "K4 pack_payload", "wire emit"),
    "gop encode recon": ("K5 quantize_image", "K5 recon_step",
                         "K6+K7 search_predict", "K4 pack_coeffs",
                         "K3 byte_histogram", "Huffman dict",
                         "K4 pack_payload", "wire emit"),
    # The sharded video in a world of one (Huffman on and off): the
    # stripe's search, K1 on its residual stack, K2 and K4 over the block
    # and vector segments; with Huffman the windowed K3 over the spliced
    # stream, the dict and K4 pack_payload over it.
    "sharded video raw": ("K6+K7 search_residual_stripe", "K1 encode_locals",
                          "K2 pack_segments", "K4 pack_records segments",
                          "K3 byte_histogram_rows", "Huffman dict batch",
                          "K4 pack_payload batch", "wire emit"),
    "sharded video recon": ("K6+K7 search_predict_stripe", "K5 recon_step",
                            "K1 encode_locals", "K2 pack_segments",
                            "K4 pack_records segments",
                            "K3 byte_histogram_rows", "Huffman dict batch",
                            "K4 pack_payload batch", "wire emit"),
    "sharded video decode": ("D1 huffman_decode", "D2 walk_video",
                             "vector read", "D3 decode_blocks", "K7 predict"),
}
DECODE_PATHS = ("image decode", "video decode", "image batch decode",
                "sharded decode", "sharded video decode")
# No encode path launches these.
DECODE = ("D1 huffman_decode", "D2 walk_offsets", "D2 walk_video",
          "vector read", "D3 decode_blocks")
ALONE = ("K6 motion_search",)  # no path launches it
# No encode path launches the search or the prediction alone: the
# search's epilogue takes their place there.  K7 alone runs on the video
# decode.
NOT_ON_ENCODE = (*ALONE, "K7 predict")
# A packer's output is defined up to the stream's last word (the plain
# versions zero the rest of the buffer, the kernels leave it): compare
# that part.
STREAM_OUT = ("K2 pack_locals", "K2 pack_locals+hist", "K4 pack_records",
              "K4 pack_payload", "K4 pack_coeffs", "K4 pack_coeffs+hist")
# The same over a batch: one K2 call a batch, its streams in rows.
BATCH_OUT = ("K2 pack_locals batch", "K2 pack_locals+hist batch",
             "K4 pack_payload batch", "K2 pack_segments",
             "K4 pack_payload window", "K4 pack_records segments")
# The emit's buffer is defined up to its last stream's padded end.
WIRE_OUT = ("wire emit",)
# One sharded image encode launches these once each (K3 rows twice with
# stage 2), and no other.
SHARDED_CALL = {False: dict.fromkeys(PATHS["sharded image"], 1),
                True: {"K1 encode_locals": 1, "K2 pack_segments": 1,
                       "K3 byte_histogram_rows": 2, "Huffman dict batch": 1,
                       "K4 pack_payload window": 1, "wire emit": 1}}
SPIN_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep's cycles a second, at most
L2_FLUSH_BYTES = 2 * 50 * 2 ** 20  # twice the H100's 50 MB L2
# Timed with the L2 flushed before each call: on its path K7 reads the
# reference planes D3 has just written, which its repeated timing would
# otherwise find in the L2 (and run under its HBM bound).
COLD = ("K7 predict",)
SHARDED_SAMPLES = 20  # per sharded timing
GOP_REPS = 3  # timed GOP-distributed encodes in each process
# The sharded video in two gloo processes on the card, a (1, 2) mesh: two
# stripes of 352 rows (720 rows are 45 macroblock rows, which two stripes
# cannot split).
VIDEO_PAIR = (1280, 704, 24)
# One encode_image with Huffman on launches these once each, and no other.
IMAGE_CALL = ("K1 encode_locals", "K2 pack_locals+hist", "Huffman dict",
              "K4 pack_payload", "wire emit")
# So does one encode_image_batch, whatever its B; without Huffman, K1, K2
# pack_locals batch and the emit.
BATCH_CALL = ("K1 encode_locals", "K2 pack_locals+hist batch",
              "Huffman dict batch", "K4 pack_payload batch", "wire emit")
# D1's payload is defined up to its byte count (its second output).
PAYLOAD_OUT = ("D1 huffman_decode",)
# The outputs a wrapper is handed as keywords on the recon paths (frame k
# of every GOP of the loop's buffers): the kernel and its plain version
# each get fresh ones of the same shapes and strides, so that they neither
# compare a tensor with itself nor write into the path's buffers.  Any
# other wrapper's ``out`` is dropped: the wrapper makes its own.
OUT_KWARGS = {"K5 quantize_image": ("out", "lens"),
              "K5 recon_step": ("out", "recon", "lens"),
              "K6+K7 search_predict": ("mvec", "out"),
              "K6+K7 search_predict_stripe": ("mvec", "out")}
# One 720p25 recon encode at gop 4, Huffman on, launches these (counts from
# 0), and no other: K5 once over the 7 I-frames, then 3 GOP steps of the
# search and the recon step, each over frame k of every GOP.
RECON_CALL = {"K5 quantize_image": 1, "K6+K7 search_predict": GOP - 1,
              "K5 recon_step": GOP - 1, "K4 pack_coeffs+hist": 1,
              "Huffman dict": 1, "K4 pack_payload": 1, "wire emit": 1}
# One sharded recon encode at gop 4, Huffman on, launches these (counts
# from 0), and no other, in a world of one and in each process of the
# (1, 2) pair: the stripe search and the recon step once a GOP step, over
# frame k of every GOP of the rank's chunk; then K1 on the residual
# stack, the segments' packers and the Huffman stage.
SHARDED_RECON_CALL = {"K6+K7 search_predict_stripe": GOP - 1,
                      "K5 recon_step": GOP - 1, "K1 encode_locals": 1,
                      "K2 pack_segments": 1, "K4 pack_records segments": 1,
                      "K3 byte_histogram_rows": 1, "Huffman dict batch": 1,
                      "K4 pack_payload batch": 1, "wire emit": 1}


def synthetic(h: int, w: int, seed: int):
    """A smooth field plus noise, u8 [h, w]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = (128.0 + 60.0 * np.sin(x / 37.0) * np.cos(y / 23.0)
         + 30.0 * np.sin((x + y) / 91.0) + rng.normal(0.0, 6.0, (h, w)))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def video_frames(w: int, h: int, n: int, seed: int):
    """bench.py's video content: 8x8 random blocks moving by (2, 3) pixels
    a frame, plus Gaussian noise of sigma 3; u8 [n, h, w]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    return np.stack([np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                             + rng.normal(0, 3, base.shape), 0, 255)
                     .astype(np.uint8) for f in range(n)])


def yuv420(frames) -> bytes:
    """Y planes and a mid-grey UV fill, as encode_video reads them."""
    h, w = frames.shape[1:]
    return b"".join(f.tobytes() + bytes([0x80]) * (w * h // 2)
                    for f in frames)


def smoke_images() -> list:
    """The two full-size test images: u8 [H, W] at each of SHAPES."""
    return [synthetic(h, w, 2 + i) for i, (h, w) in enumerate(SHAPES)]


def serving_batch():
    """The serving cell's batch, u8 [B, H, W] at BATCHES[0]: smooth images
    and, last, a noise image (at full size noise still pays for the dict,
    so no full-size stream takes the fallback)."""
    import numpy as np

    bq, bh, bw = BATCHES[0]
    return np.stack([synthetic(bh, bw, 100 + k) for k in range(bq - 1)]
                    + [np.random.default_rng(9).integers(
                        0, 256, (bh, bw), dtype=np.uint8)])


def chain_stats(name: str, args, kwargs, label: str) -> dict:
    """D1's or D2's stats (cuda_decode.CHAIN_STATS) on a captured call's
    inputs, printed; the output with stats must equal the output without
    (the call check_kernel held against the plain version).  breaks_left
    says which path D1 took: 0, the rounds settled every break; 1, the
    table settled what they left (D1 has no sweep: its sweep entries are
    0)."""
    import torch

    cd = module("cuda_decode")
    stats = torch.zeros(len(cd.CHAIN_STATS), dtype=torch.int64,
                        device=args[0].device)
    got = getattr(cd, KERNELS[name][1])(*args, **kwargs, stats=stats)
    want = getattr(cd, KERNELS[name][1])(*args, **kwargs)
    if name == "D1 huffman_decode":
        n = int(want[1])
        same = int(got[1]) == n and torch.equal(got[0][:n], want[0][:n])
    else:
        same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        raise AssertionError(f"{name} ({label}) with stats differs from "
                             f"the call without")
    st = dict(zip(cd.CHAIN_STATS, stats.tolist()))
    rounds = cd.CHAIN_ROUNDS if name == "D1 huffman_decode" else 0
    print(f"{name} ({label}, {rounds} rounds): "
          + ", ".join(f"{k} {v}" for k, v in st.items()), flush=True)
    return {f"chain_{k}": v for k, v in st.items()}


def module(name: str):
    import importlib

    return importlib.import_module(f"imageencoder_tpu_torch.ops.{name}")


@contextlib.contextmanager
def chunked_passes():
    """Encodes inside the block take the JAX package's 32 frames a pass,
    as the plain versions do, so a clip past them goes in chunks spliced
    on the host (a card's frame budget would take it in one pass)."""
    from imageencoder_tpu_torch.models import video

    real = video.frames_per_pass
    video.frames_per_pass = lambda *args: real(*args[:6], device="cpu")
    try:
        yield
    finally:
        video.frames_per_pass = real


@contextlib.contextmanager
def captured_calls():
    """Record the (args, kwargs) of every kernel-wrapper call made inside
    the block: the main path looks its wrappers up on their modules at
    each call, so a recording stand-in there sees the real inputs.  The
    wrappers are put back on exit."""
    calls = {name: [] for name in KERNELS}
    saved = []
    for name, (mod_name, attr, *_) in KERNELS.items():
        mod = module(mod_name)
        real = getattr(mod, attr)

        def record(*args, _real=real, _calls=calls[name], **kwargs):
            _calls.append((args, kwargs))
            return _real(*args, **kwargs)

        # A wrapper counts its launches on the name its module binds.
        record.launches = 0
        saved.append((mod, attr, real))
        setattr(mod, attr, record)
    try:
        yield calls
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


_FLUSH = {}


def flush_l2() -> None:
    """Write twice the card's L2 of a scratch buffer, so that the next
    kernel reads its inputs from HBM, not from lines an earlier call left
    in the L2."""
    import torch

    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                    device="cuda")
    _FLUSH["buf"].zero_()


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event milliseconds per call of fn() run back to back."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event milliseconds per call of fn() run back to back
    behind a spin kernel that keeps the card busy while the host queues
    the calls: the card's time for them, not the host's launch rate
    (where fn waits for the card, the host's time shows again)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(2.0 * reps * (time.perf_counter() - t0), 1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_rows(fn, reps: int, counts: dict | None = None):
    """(device microseconds per call by operation, host wall ms per call)
    of fn() under torch.profiler; ``counts``, where given, receives the
    device operations per call by operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = {}
    for e in prof.key_averages():
        # Device rows only: an aten op's row repeats its kernels' time.
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if t is None else t
        rows[e.key] = rows.get(e.key, 0.0) + us / reps
        if counts is not None:
            counts[e.key] = counts.get(e.key, 0.0) + e.count / reps
    return rows, wall_ms


def profiled_ms(fn, symbol=None, reps: int = 20, tries: int = 3) -> float:
    """Device milliseconds per call of fn() from torch.profiler: the
    kernels whose name contains ``symbol`` (or one of them, for a tuple:
    a wrapper of several launches), or all device work.  The profiler
    now and then drops device records.  Where it keeps some of an
    operation's (seen a fractional number of times a call), the
    operation's time a call is its mean over the records kept times its
    whole count a call (at least 1), and a line says so where that moves
    the time by more than 5%.  A run without any is profiled again after
    a pause, up to ``tries`` times in all; if none has them, the time is
    the CUDA-event time of the call's device work (:func:`queued_ms`),
    and a line says so."""
    symbols = as_tuple(symbol) if symbol else ()
    for attempt in range(tries):
        counts = {}
        rows, _ = device_rows(fn, reps, counts)
        keys = [key for key in rows
                if not symbols or any(sym in key for sym in symbols)]
        seen = sum(rows[key] for key in keys)
        if seen > 0.0:
            us = sum(rows[key] / counts[key] * max(1, round(counts[key]))
                     for key in keys if counts[key] > 0)
            if us > 1.05 * seen:
                print(f"profiler: some device records of "
                      f"{symbol or 'the call'} dropped (seen a call: "
                      + ", ".join(f"{counts[key]:g}" for key in keys)
                      + f"); {seen / 1e3:.4f} ms seen, {us / 1e3:.4f} ms "
                      f"from the means of the records kept", flush=True)
            return us / 1e3
        print(f"profiler: no device records for {symbol or 'the call'}; "
              f"profiling again", flush=True)
        time.sleep(0.25 * (attempt + 1))
    ms = queued_ms(fn, reps)
    print(f"profiler: no device records for {symbol or 'the call'} in "
          f"{tries} runs; timed the call's device work with CUDA events "
          f"instead (queued behind a spin kernel), {ms:.4f} ms", flush=True)
    return ms


def quantiles(samples) -> tuple[float, float]:
    """(median, p90) of a list of seconds, in milliseconds."""
    s = sorted(samples)
    return s[len(s) // 2] * 1e3, s[int(len(s) * 0.9)] * 1e3


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over int tensors of equal shape (0 when bit-equal)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def tensor_bytes(xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor) and x.dim() > 0)


def record_bytes(lens) -> int:
    """The bytes K2 must read of records of these bit lengths: each
    length (4 bytes) and the register-file words the record fills."""
    import torch

    lens = lens.to(torch.int64)
    return 4 * lens.numel() + 4 * int(((lens + 31) // 32).sum())


def reps_for(fn, budget_s: float = 0.4) -> int:
    """Repetitions of fn() that fit about budget_s, between 2 and 20: the
    plain versions of K6 take tenths of a second per call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(2, min(20, int(budget_s / (time.perf_counter() - t0))))


def calls_of(name: str, args: tuple, kwargs: dict):
    """(kernel call, plain call): the wrapper and its plain version bound
    to one captured argument list, each returning a tuple."""
    import torch

    mod_name, attr, plain_attr, *_ = KERNELS[name]
    mod = module(mod_name)
    kernel, plain = getattr(mod, attr), getattr(mod, plain_attr)
    outs = OUT_KWARGS.get(name, ())

    def fresh() -> dict:
        """The keywords, each output in ``outs`` a new buffer of its
        shape and strides, any other ``out`` left to the wrapper
        (OUT_KWARGS)."""
        return {k: (torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                        device=v.device)
                    if k in outs and v is not None else v)
                for k, v in kwargs.items() if k in outs or k != "out"}

    kernel_kw, plain_kw = fresh(), fresh()

    def kernel_call():
        return as_tuple(kernel(*args, **kernel_kw))

    def plain_call():
        return as_tuple(plain(*args, **plain_kw))

    return kernel_call, plain_call


def held_equal(name: str, args: tuple, kwargs: dict):
    """Run kernel and plain version on one captured argument list; raise
    unless bit-equal.  Returns (max abs err, the kernel's outputs)."""
    import torch

    kernel_call, plain_call = calls_of(name, args, kwargs)
    got, want = kernel_call(), plain_call()
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, plain "
                             f"{len(want)}")
    if name in STREAM_OUT:
        from imageencoder_tpu_torch.ops.cuda_pack import stream_words

        got = (stream_words(*got[:2]), *got[1:])
        want = (stream_words(*want[:2]), *want[1:])
    if name in BATCH_OUT:  # each stream's words, then the totals, ...
        from imageencoder_tpu_torch.ops.cuda_pack import stream_words

        got = (*map(stream_words, got[0], got[1]), *got[1:])
        want = (*map(stream_words, want[0], want[1]), *want[1:])
    if name in PAYLOAD_OUT:
        got = (got[0][:int(got[1])], got[1])
        want = (want[0][:int(want[1])], want[1])
    if name in WIRE_OUT:
        end = wire_end(args)
        got, want = (got[0][:end],), (want[0][:end],)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err, got


def f64_ops_per_block(k: int, recon: bool) -> int:
    """Separately rounded f64 ops of one block's transform: K*K multiplies
    and adds, then a scale multiply and a divide per coefficient; the
    recon step adds the dequantize multiply, the inverse's K*K multiplies
    and adds, and two adds a pixel (+ 128, + prediction)."""
    fwd = 2 * k * k + 2 * k
    return fwd + (k + 2 * k * k + 2 * k if recon else 0)


def operations(name: str, args: tuple,
               kwargs: dict) -> tuple[float, float]:
    """(ops, ops/s of their type) the function does on these inputs; 0 ops
    for the kernels that only move bytes."""
    from imageencoder_tpu_torch.ops.motion import MACRO, search_steps

    if name == "D3 decode_blocks":
        # The dequantize multiply, the inverse's K*K multiplies and adds
        # and the + 128 a sample: 544 a 4x4 block; with a prediction one
        # more add a sample.
        k = args[6] * args[6]
        pred = kwargs.get("pred") is not None
        return (args[2].numel() * (2 * k + 2 * k * k + k * pred),
                F64_OPS_PER_S)
    if name in ("K1 encode_locals", "K5 quantize_image", "K5 recon_step"):
        at = 3 if name == "K5 recon_step" else 2  # the block size argument
        b = args[at] if len(args) > at else 4
        blocks = args[0].numel() // (b * b)
        return (blocks * f64_ops_per_block(b * b, name == "K5 recon_step"),
                F64_OPS_PER_S)
    if name in ("K6 motion_search", "K6+K7 search_predict",
                "K6+K7 search_residual", "K6+K7 search_residual_stripe",
                "K6+K7 search_predict_stripe"):
        # 9 candidates on the first level, 8 on each further one (the
        # centre's SAD is the previous level's best); of a whole video
        # only the P-frames are searched.
        f, h, w = args[0].shape
        merange = args[-1]
        if name == "K6+K7 search_residual":
            f = len(module("cuda_motion").p_frames(f, args[1]))
            merange = args[2]
        elif name == "K6+K7 search_residual_stripe":
            f = len(stripe_p_frames(args))
        levels = len(search_steps(merange))
        candidates = 9 + 8 * (levels - 1) if levels else 0
        byte_sads = (f * (h // MACRO) * (w // MACRO) * candidates
                     * MACRO * MACRO)
        return byte_sads / 4, INT32_OPS_PER_S  # 4 bytes a __vsadu4
    return 0.0, 1.0


def stripe_p_frames(args) -> list:
    """The P-frames a stripe search's arguments search (all of its frames
    but for search_residual_stripe, whose f0 and gop pick them)."""
    if len(args) == 8:  # cur, ref, row0, halo, h_glob, f0, gop, merange
        return module("cuda_motion").p_frames(args[0].shape[0], args[6],
                                              args[5])
    return list(range(args[0].shape[0]))


def stripe_bytes(args, got) -> int:
    """The bytes a stripe search must move: cur, the reference rows of its
    searched frames that lie in the frame (its halo rows past the frame's
    edges are never read), the outputs."""
    cur, _, row0, halo, h_glob = args[:5]
    f, h, w = cur.shape
    rows = min(h_glob, row0 + h + halo) - max(0, row0 - halo)
    return (cur.numel() + len(stripe_p_frames(args)) * rows * w
            + tensor_bytes(got))


def wire_sources_of(args) -> list:
    """(bits, fallback) of each stream of the wire emit's arguments
    (words, total_bits, tables, payload), as the emit reads them."""
    return module("cuda_pack").wire_sources(*args[1:3])


def wire_end(args) -> int:
    """The end of the emit's last stream, padded to 16 bytes: every byte
    of its buffer before it is defined."""
    nbytes, offsets, _ = module("cuda_pack").wire_layout(
        wire_sources_of(args), args[0].shape[1])
    return offsets[-1] + -(-nbytes[-1] // 16) * 16 if nbytes else 0


def wire_bytes_moved(args) -> int:
    """The bytes the emit must move: each stream's source bytes read once
    and its wire bytes written once, and the 8 bytes a stream of its total
    or its table's fields it reads."""
    cp = module("cuda_pack")
    sources = wire_sources_of(args)
    return sum((bits + 7) // 8 + cp.wire_nbytes(bits, fb) + 8
               for bits, fb in sources if bits >= 0)


def flip_ms(args) -> float:
    """Device ms of torch.flip over each stream's source words seen as
    bytes, four to a word: the byte swap alone, one PyTorch call on the
    same bytes (gathered beforehand where the batch has several streams),
    checked against the emit's bytes on a stream that does not fall
    back."""
    import torch

    words, _, tables, payload = (*args, None, None)[:4]
    srcs, check = [], None
    for k, (bits, fb) in enumerate(wire_sources_of(args)):
        if bits < 0:
            continue
        row = words[k] if tables is None or fb else payload[k]
        srcs.append(row[:-(-((bits + 7) // 8) // 4)])
        if check is None and not fb:
            check = (srcs[-1], (bits + 7) // 8,
                     module("cuda_pack").wire_bytes(row, bits))
    src = torch.cat(srcs) if len(srcs) > 1 else srcs[0].contiguous()
    if check is not None:
        row, nbytes, want = check
        got = torch.flip(row.contiguous().view(torch.uint8).view(-1, 4),
                         [1]).reshape(-1)[:nbytes]
        if not torch.equal(got, want):
            raise AssertionError("torch.flip disagrees with the emit")
    return profiled_ms(lambda: torch.flip(src.view(torch.uint8).view(-1, 4),
                                          [1]))


def block_host_serialization() -> None:
    """Replace device_pack.words_to_bytes and huffman._fallback, the host
    serialization the wire emit replaced, by functions that raise, in
    every module of the port that binds them: a path that still called
    them fails the run.  Once a process; they stay blocked."""
    import importlib

    dp, hf = module("device_pack"), module("huffman")
    for attr, owner in (("words_to_bytes", dp), ("_fallback", hf)):
        real = getattr(owner, attr)
        if getattr(real, "blocked", False):
            continue

        def refuse(*args, _attr=attr, **kwargs):
            raise AssertionError(f"{_attr} was called: the wire emit "
                                 f"takes its place on every path")

        refuse.blocked = True
        for name in list(sys.modules):
            if name.startswith("imageencoder_tpu_torch"):
                mod = importlib.import_module(name)
                if getattr(mod, attr, None) is real:
                    setattr(mod, attr, refuse)


def bincount_ms(words, total_bits) -> float:
    """Device ms of torch.bincount over the stream's bytes (the first
    ceil(total / 8) bytes of the words in memory order, which for a whole
    number of words are the stream's own), checked against K3."""
    import torch

    from imageencoder_tpu_torch.ops import cuda_kernels

    nbytes = (int(total_bits) + 7) // 8
    data = words.view(torch.uint8)[:nbytes]
    hist = torch.bincount(data, minlength=256)
    want = cuda_kernels.byte_histogram(words, total_bits)
    # Bytes of a partial last word are taken from its other end.
    if int((hist - want).abs().sum()) > 2 * (nbytes % 4):
        raise AssertionError("torch.bincount disagrees with K3")
    return profiled_ms(lambda: torch.bincount(data, minlength=256))


def check_kernel(name: str, args: tuple, kwargs: dict) -> dict:
    """Hold one kernel against its plain version on the arguments the main
    path gave it, and time both."""
    import torch

    _, _, _, symbol, source, replaces = KERNELS[name]
    kernel_call, plain_call = calls_of(name, args, kwargs)
    err, got = held_equal(name, args, kwargs)
    # The bytes the kernel itself must move: its tensor inputs, and its
    # outputs up to the stream's end where the output is a stream.  K2
    # reads the lengths, the register-file words its records fill and,
    # for a video, the vectors.  K4
    # pack_records reads a record's values only where the record is not
    # empty; pack_payload the nbytes stream bytes once (its design reads
    # them in both launches: that second read is its loss, not its bound)
    # and the dict's table; pack_coeffs 4 bytes a coefficient
    # and the vectors.  A packer
    # with the histogram also writes its 256 bins.  The dict kernel reads
    # the histogram and the total and writes the table.
    hist_bytes = 1024 if name.endswith("+hist") else 0
    if name in ("K2 pack_locals", "K2 pack_locals+hist"):
        nbytes = (record_bytes(args[1]) + tensor_bytes([kwargs.get("mvecs")])
                  + (int(got[1]) + 7) // 8 + hist_bytes)
    elif name == "K4 pack_records":
        live = int((args[1].sum(dim=1) > 0).sum())
        nbytes = (tensor_bytes(args[1:2]) + 4 * args[0].shape[1] * live
                  + (int(got[1]) + 7) // 8)
    elif name == "K4 pack_payload":
        # The bytes it codes, once; the table; the codes.
        from imageencoder_tpu_torch.ops.dict_table import fields

        nbytes = (fields(args[1])["nbytes"] + tensor_bytes(args[1:2])
                  + (int(got[1]) + 7) // 8)
    elif name in ("K4 pack_coeffs", "K4 pack_coeffs+hist"):
        # The coefficients, the vectors and the lengths K5 and the recon
        # step wrote (launch 1 reads those alone).
        nbytes = (tensor_bytes([*args[:2], kwargs.get("lens")])
                  + (int(got[1]) + 7) // 8 + hist_bytes)
    elif name == "Huffman dict":
        nbytes = 1024 + 8 + tensor_bytes(got)
    elif name in ("K2 pack_locals batch", "K2 pack_locals+hist batch"):
        # B-fold K2's: the register files and lengths, each stream's
        # bytes (and bins).
        hist = name == "K2 pack_locals+hist batch"
        nbytes = (record_bytes(args[1])
                  + sum((int(t) + 7) // 8 for t in got[-2 if hist else -1])
                  + 1024 * args[0].shape[0] * hist)
    elif name == "Huffman dict batch":
        nbytes = (1024 + 8) * args[0].shape[0] + tensor_bytes(got)
    elif name in ("K4 pack_payload batch", "K4 pack_payload window"):
        # The bytes each row codes ([first_byte, nbytes) of its table),
        # once; the tables; the codes out.
        from imageencoder_tpu_torch.ops.dict_table import fields

        nbytes = (sum(max(f["nbytes"] - f["first_byte"], 0)
                          for f in map(fields, args[1]))
                  + tensor_bytes(args[1:2])
                  + sum((int(t) + 7) // 8 for t in got[-1]))
    elif name == "K2 pack_segments":
        # The records and lengths in, each segment's bytes out.
        nbytes = (record_bytes(args[1])
                  + sum((int(t) + 7) // 8 for t in got[-1]))
    elif name == "K3 byte_histogram_rows":
        # Each row's window in, 256 bins a row out.
        nbytes = (int((args[2] - args[1]).clamp(min=0).sum())
                  + tensor_bytes(got))
    elif name == "K3 byte_histogram":
        nbytes = (int(args[1]) + 7) // 8
    elif name == "D1 huffman_decode":
        # The stream and its decode table in, the payload and its count
        # out.
        nbytes = int(args[1]) + tensor_bytes([args[3]]) + int(got[1]) + 8
    elif name == "D2 walk_offsets":
        # The payload in, 16 bytes a record and the end bit out.
        nbytes = int(args[1]) + 16 * args[3] + 8
    elif name == "D2 walk_video":
        # The payload in; 16 bytes a record, two start bits a frame and
        # the end bit out.
        nbytes = int(args[1]) + 16 * args[3] * args[4] + 16 * args[3] + 8
    elif name == "vector read":
        # The P-frames' vector bits and the start bits in, the vectors out.
        gop, n_macro, mb = args[3:6]
        n_p = len(module("cuda_motion").p_frames(args[2].shape[0], gop))
        nbytes = (n_p * 2 * n_macro * mb + 7) // 8 + tensor_bytes(
            [args[2]]) + tensor_bytes(got)
    elif name == "D3 decode_blocks":
        # The records' fields (b bits each, min(count, K) of them), 16
        # bytes a record, the quant and the prediction in, the pixels out.
        k = args[6] * args[6]
        fields = int((args[3].to(torch.int64)
                      * args[4].clamp(max=k).to(torch.int64)).sum())
        nbytes = ((fields + 7) // 8 + 16 * args[2].numel()
                  + tensor_bytes([args[5], kwargs.get("pred")])
                  + tensor_bytes(got))
    elif name in ("K6+K7 search_residual_stripe",
                  "K6+K7 search_predict_stripe"):
        nbytes = stripe_bytes(args, got)
    elif name == "K4 pack_records segments":
        # The widths, the values of the records that are not empty, each
        # segment's bytes out.
        live = int((args[1].sum(dim=-1) > 0).sum())
        nbytes = (tensor_bytes(args[1:2]) + 4 * args[0].shape[-1] * live
                  + sum((int(t) + 7) // 8 for t in got[-1]))
    elif name in ("K6 motion_search", "K7 predict", "K5 recon_step",
                  "K6+K7 search_predict"):
        nbytes = tensor_bytes(args[:2]) + tensor_bytes(got)
    elif name == "wire emit":
        nbytes = wire_bytes_moved(args)
    else:
        nbytes = tensor_bytes(args[:1]) + tensor_bytes(got)
    ops, rate = operations(name, args, kwargs)
    hbm_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    plain_reps = reps_for(plain_call)
    plain_call_ms = cuda_ms(plain_call, plain_reps)
    call_ms = (cuda_ms(kernel_call) + cuda_ms(kernel_call)) / 2
    plain_call_ms = (plain_call_ms + cuda_ms(plain_call, plain_reps)) / 2
    if name in COLD:  # each call after a flush; the flush's rows not summed
        ms = profiled_ms(lambda: (flush_l2(), kernel_call()), symbol)
    else:
        ms = profiled_ms(kernel_call, symbol)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms,
           "plain_ms": profiled_ms(plain_call, reps=plain_reps),
           "bound_ms": max(hbm_ms, ops_ms),
           "bound_by": "operations" if ops_ms > hbm_ms else "bytes",
           "library_ms": (bincount_ms(*args) if name == "K3 byte_histogram"
                          else flip_ms(args) if name == "wire emit"
                          else None),
           "stage_ms": profiled_ms(kernel_call),
           "call_ms": call_ms, "plain_call_ms": plain_call_ms,
           "bytes": nbytes, "ops": ops, "hbm_floor_ms": hbm_ms}
    if name in COLD:
        row["l2_warm_ms"] = profiled_ms(kernel_call, symbol)
    shapes = ", ".join(str(tuple(a.shape)) for a in args
                       if isinstance(a, torch.Tensor))
    lib = ("" if row["library_ms"] is None else
           f"; {'torch.flip' if name == 'wire emit' else 'torch.bincount'} "
           f"{row['library_ms']:.4f} ms")
    cold = ("" if name not in COLD else f" with the L2 flushed before each "
            f"call ({row['l2_warm_ms']:.4f} ms without)")
    print(f"{name} on {shapes}: bit-equal to plain; device {row['ms']:.4f} "
          f"ms{cold} (plain {row['plain_ms']:.4f} ms; the wrapper's whole "
          f"device work {row['stage_ms']:.4f} ms); per call {call_ms:.4f} ms "
          f"(plain {plain_call_ms:.4f} ms); bound {row['bound_ms']:.4f} ms "
          f"by {row['bound_by']} (HBM floor {hbm_ms:.4f} ms for {nbytes} "
          f"bytes, op floor {ops_ms:.4f} ms for {ops:.0f} ops){lib}",
          flush=True)
    return row


def beside(row: dict, key: str, other: dict) -> None:
    """Put a kernel's row at another path's shapes under ``key``."""
    row[key] = {k: other[k] for k in ROW_KEYS}


def launches_of(wrappers: dict, drive) -> dict:
    """Every wrapper's launches in drive(): the counts set to 0 just
    before it, read just after."""
    import torch

    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    drive()
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in wrappers.items()}


def phase_of_path(path: str, wrappers: dict, drive) -> dict:
    """Drive one path with every launch count at 0 just before it; return
    the counts just after (:func:`check_path`)."""
    return check_path(path, launches_of(wrappers, drive))


def check_path(path: str, counts: dict) -> dict:
    """Fail if a kernel of the path is at 0 in ``counts``, if a path that
    does not list K3 launches it, if a decode kernel runs on an encode
    path or a kernel not its own on a decode path, or if an encode path
    launches K6 or K7 alone; print and return the counts."""
    decode = path in DECODE_PATHS
    for name in PATHS[path]:
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the {path} "
                                 f"path")
    for name in KERNELS:
        if counts[name] and name not in PATHS[path] and (
                decode or name in DECODE):
            raise AssertionError(f"{name} was launched {counts[name]} times "
                                 f"on the {path} path")
    if "K3 byte_histogram" not in PATHS[path] and counts["K3 byte_histogram"]:
        raise AssertionError(f"K3 was launched on the {path} path: its "
                             f"packers count the histogram")
    for name in () if decode else NOT_ON_ENCODE:
        if counts[name]:
            raise AssertionError(f"{name} was launched {counts[name]} times "
                                 f"on the {path} path: the search's epilogue "
                                 f"takes its place there")
    print(f"{path} path launches: " + ", ".join(
        f"{name} {counts[name]}" for name in KERNELS), flush=True)
    return counts


def time_video(frames_np, quant, ref_mode: str, dev) -> None:
    """Phase 5 for one reference mode at the full video size."""
    import numpy as np
    import torch

    from imageencoder_tpu_torch.models.video import (MAX_FRAMES_PER_CALL,
                                                     encode_frames,
                                                     video_header)
    from imageencoder_tpu_torch.models.video import VideoParams, mvec_bits
    from imageencoder_tpu_torch.ops.device_pack import header_to_words
    from imageencoder_tpu_torch.ops.huffman import huffman_encode_from_hist
    from imageencoder_tpu_torch.ops.video_pipeline import (
        make_encode_video_packed, make_encode_video_packed_recon)

    w, h, n = VIDEO
    assert n <= MAX_FRAMES_PER_CALL
    mpix = w * h * n / 1e6
    t = []
    for _ in range(VIDEO_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr_d = torch.from_numpy(frames_np).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    h2d = quantiles(t)

    writer = video_header(quant, True, w, h, VideoParams(n, GOP, MERANGE),
                          True)
    hdr = torch.from_numpy(header_to_words(writer.getvalue())
                           .view(np.int32)).to(dev)
    factory = (make_encode_video_packed if ref_mode == "raw"
               else make_encode_video_packed_recon)
    enc = factory(GOP, MERANGE, mvec_bits(MERANGE), 4, True, "reference",
                  with_hist=True)
    qf = quant.as_float()
    packed = enc(fr_d, qf, writer.position, hdr)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(VIDEO_SAMPLES)]
    for start, end in ev:
        start.record()
        enc(fr_d, qf, writer.position, hdr)
        end.record()
    torch.cuda.synchronize()
    window = quantiles([s.elapsed_time(e) / 1e3 for s, e in ev])
    busy = profiled_ms(lambda: enc(fr_d, qf, writer.position, hdr),
                       reps=VIDEO_PROFILE_CALLS)

    t = []
    for _ in range(VIDEO_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        huffman_encode_from_hist(*packed)
        t.append(time.perf_counter() - t0)
    huff = quantiles(t)

    t = []
    for _ in range(VIDEO_SAMPLES):
        t0 = time.perf_counter()
        encode_frames(fr_d, w, h, quant, True, GOP, MERANGE,
                      use_huffman=True, ref_mode=ref_mode, device=dev)
        t.append(time.perf_counter() - t0)
    e2e = quantiles(t)
    print(f"video {ref_mode} {w}x{h}x{n}: encode_video of frames on the "
          f"device, Huffman on: median {e2e[0]:.3f} ms, p90 {e2e[1]:.3f} ms "
          f"(n={VIDEO_SAMPLES}; {mpix / e2e[0] * 1e3:.1f} Mpix/s); device "
          f"window until the histogram median {window[0]:.3f} ms, p90 "
          f"{window[1]:.3f} ms ({mpix / window[0] * 1e3:.1f} Mpix/s), of "
          f"which device busy {busy:.3f} ms; Huffman stage (dict, payload, "
          f"the wait and the copies) median {huff[0]:.3f} ms, p90 "
          f"{huff[1]:.3f} ms; H2D copy of the frames "
          f"median {h2d[0]:.3f} ms, p90 {h2d[1]:.3f} ms", flush=True)


def time_decode(data: bytes, h: int, w: int, dev) -> None:
    """Phase 6 for the decode of one Huffman stream: the host's parse, the
    stream's upload, the device window (D1-D3, CUDA events) and the whole
    decode_image until its pixels are ready."""
    import torch

    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.models.image import (decode_uploaded,
                                                     parse_stream, upload)

    mpix = h * w / 1e6
    t = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        plan = parse_stream(data, pinned=True)
        t.append(time.perf_counter() - t0)
    parse = quantiles(t)
    t = []
    for _ in range(SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views = upload(plan, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    up = quantiles(t)
    decode_uploaded(plan, views)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(SAMPLES)]
    for start, end in ev:
        start.record()
        decode_uploaded(plan, views)
        end.record()
    torch.cuda.synchronize()
    window = quantiles([s.elapsed_time(e) / 1e3 for s, e in ev])
    busy = profiled_ms(lambda: decode_uploaded(plan, views))
    t = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        port.decode_image(data, device=dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    e2e = quantiles(t)
    print(f"{w}x{h} decode, Huffman on ({len(data)} bytes): decode_image "
          f"until the pixels are ready median {e2e[0]:.3f} ms, p90 "
          f"{e2e[1]:.3f} ms (n={SAMPLES}; {mpix / e2e[0] * 1e3:.1f} "
          f"Mpix/s); host parse (dict, table, header, staging) median "
          f"{parse[0]:.3f} ms, p90 {parse[1]:.3f} ms; upload median "
          f"{up[0]:.3f} ms, p90 {up[1]:.3f} ms; device window D1-D3 median "
          f"{window[0]:.4f} ms, p90 {window[1]:.4f} ms "
          f"({mpix / window[0] * 1e3:.1f} Mpix/s), of which device busy "
          f"{busy:.4f} ms", flush=True)


def time_video_decode(data: bytes, n: int, h: int, w: int, dev) -> None:
    """Phase 6 for the decode of one video stream: the host's parse, the
    stream's upload, the device window (D1, D2, the vector read, D3 and K7;
    CUDA events), decode_frames until its frames are ready, and
    decode_video with the copy of its YUV420 frames to the host."""
    import torch

    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.models.image import upload
    from imageencoder_tpu_torch.models.video import decode_into, plan_video

    mpix = n * h * w / 1e6
    t = []
    for _ in range(VIDEO_SAMPLES):
        t0 = time.perf_counter()
        plan = plan_video(data, pinned=True)
        t.append(time.perf_counter() - t0)
    parse = quantiles(t)
    t = []
    for _ in range(VIDEO_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views = upload(plan, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    up = quantiles(t)
    y = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    decode_into(plan, views, y)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(VIDEO_SAMPLES)]
    for start, end in ev:
        start.record()
        decode_into(plan, views, y)
        end.record()
    torch.cuda.synchronize()
    window = quantiles([s.elapsed_time(e) / 1e3 for s, e in ev])
    busy = profiled_ms(lambda: decode_into(plan, views, y),
                       reps=VIDEO_PROFILE_CALLS)
    e2e = {}
    for label, fn in (("decode_frames", lambda: port.decode_frames(
            data, device=dev)), ("decode_video", lambda: port.decode_video(
                data, device=dev))):
        t = []
        for _ in range(VIDEO_SAMPLES):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        e2e[label] = quantiles(t)
    f, v = e2e["decode_frames"], e2e["decode_video"]
    print(f"video decode {w}x{h}x{n}, Huffman on ({len(data)} bytes): "
          f"decode_video (YUV420 bytes on the host) median {v[0]:.3f} ms, "
          f"p90 {v[1]:.3f} ms (n={VIDEO_SAMPLES}; "
          f"{mpix / v[0] * 1e3:.1f} Mpix/s); decode_frames until the "
          f"frames are ready on the device median {f[0]:.3f} ms, p90 "
          f"{f[1]:.3f} ms ({mpix / f[0] * 1e3:.1f} Mpix/s); host parse "
          f"(dict, table, header, staging) median {parse[0]:.3f} ms, p90 "
          f"{parse[1]:.3f} ms; upload median {up[0]:.3f} ms, p90 "
          f"{up[1]:.3f} ms; device window (D1, D2, vectors, D3, K7) median "
          f"{window[0]:.4f} ms, p90 {window[1]:.4f} ms "
          f"({mpix / window[0] * 1e3:.1f} Mpix/s), of which device busy "
          f"{busy:.4f} ms", flush=True)


def time_serving(imgs_d, quant, dev) -> list:
    """Phase 6 for the serving paths, images resident on the device:
    encode_image_batch, the same images as back-to-back encode_image
    calls, encode_image_stream at STREAM_DEPTH, and decode_image_batch of
    the batch's streams (pixels left on the device), each until its
    result is ready; Mpix/s beside each median.  Returns the batch's
    streams."""
    import torch

    import imageencoder_tpu_torch as port

    b, h, w = imgs_d.shape
    mpix = b * h * w / 1e6

    def timed(fn):
        fn()
        t = []
        for _ in range(SERVING_SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        return quantiles(t)

    streams = port.encode_image_batch(imgs_d, quant, device=dev)
    got = {
        "encode_image_batch": timed(lambda: port.encode_image_batch(
            imgs_d, quant, device=dev)),
        f"{b} encode_image calls": timed(lambda: [port.encode_image(
            im, quant, use_huffman=True, device=dev) for im in imgs_d]),
        "encode_image_stream": timed(lambda: list(port.encode_image_stream(
            imgs_d, quant, depth=STREAM_DEPTH, device=dev))),
        "decode_image_batch": timed(lambda: port.decode_image_batch(
            streams, device=dev)),
    }
    busy = profiled_ms(lambda: port.encode_image_batch(imgs_d, quant,
                                                       device=dev), reps=5)
    from imageencoder_tpu_torch.models.batch import launch_batch

    tail_ms = time_tail(lambda: launch_batch(imgs_d, quant, True, True,
                                             "reference", 4))
    print(f"serving {b}x{w}x{h}, Huffman on: " + "; ".join(
        f"{label} median {med:.3f} ms, p90 {p90:.3f} ms "
        f"({mpix / med * 1e3:.1f} Mpix/s)"
        for label, (med, p90) in got.items())
          + f" (n={SERVING_SAMPLES}); encode_image_batch device busy "
          f"{busy:.4f} ms a call; {tail_ms}", flush=True)
    return streams


def time_tail(launch) -> str:
    """The host's ms of a tail (ops/huffman.py::Tail) after launch(), its
    kernels queued: median over SAMPLES of the launch, of Tail.copy (the
    wait for the lengths and the one copy queued) and of Tail.result (the
    copy's wait, where it has not landed, and one bytes a stream)."""
    import torch

    t = []
    for _ in range(SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tail = launch()
        t1 = time.perf_counter()
        tail.copy()
        t2 = time.perf_counter()
        tail.result()
        t.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    launch_ms, copy_ms, bytes_ms = (quantiles([x[k] for x in t])[0]
                                    for k in range(3))
    return (f"tail medians: launch {launch_ms:.3f} ms, copy (the lengths' "
            f"wait, the one copy) {copy_ms:.3f} ms, bytes (the copy's wait, "
            f"a bytes a stream) {bytes_ms:.3f} ms (n={SAMPLES})")


def cli_phase(image, frames) -> None:
    """Phase 8: ``python -m imageencoder_tpu_torch`` as a subprocess with
    --device cuda on an image job, on a video encoder job with a
    decoder's decfile, and on that video job with --checkpoint-dir, run
    again from the directory a run stopped after its first GOP leaves
    (meta.json and GOP 0's segment); every file it writes equals the one
    the CLI writes with --device cpu (run in this process), every exit
    code is 0, and the resumed run keeps GOP 0's segment as it was."""
    import pathlib
    import subprocess
    import tempfile

    import numpy as np

    from imageencoder_tpu_torch import cli

    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "matrix.txt").write_text("".join(
            " ".join(map(str, row)) + "\n" for row in QUANT))
        image.tofile(tmp / "in.raw")
        (tmp / "in.yuv").write_bytes(yuv420(frames))
        h, w = image.shape
        n, vh, vw = frames.shape

        def job(name: str, video: bool, device: str, *flags: str):
            keys = dict(rawfile=tmp / ("in.yuv" if video else "in.raw"),
                        encfile=tmp / f"{name}.enc",
                        decfile=tmp / f"{name}_dec.raw", rle=1,
                        quantfile=tmp / "matrix.txt",
                        width=vw if video else w, height=vh if video else h,
                        logfile=tmp / f"{name}.log")
            if video:
                keys.update(gop=GOP, merange=MERANGE)
            conf = tmp / f"{name}.conf"
            conf.write_text("".join(f"{k}={v}\n" for k, v in keys.items()))
            args = [str(conf), "--device", device, *flags]
            t0 = time.perf_counter()
            if device == "cpu":
                code = cli.main(args)
            else:
                res = subprocess.run(
                    [sys.executable, "-m", "imageencoder_tpu_torch", *args],
                    cwd=root, capture_output=True, text=True, timeout=600)
                if res.returncode != 0:
                    print(res.stderr[-4000:], flush=True)
                code = res.returncode
            if code != 0:
                raise AssertionError(f"CLI {name} exited {code}")
            print(f"CLI {name} ({' '.join(args[1:])}): exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            return [(tmp / f"{name}{ext}").read_bytes()
                    for ext in (".enc", "_dec.raw")]

        ckpt = tmp / "ckpt"
        want = {"image": job("image_cpu", False, "cpu"),
                "video": job("video_cpu", True, "cpu")}
        got = {"image": job("image_cuda", False, "cuda"),
               "video": job("video_cuda", True, "cuda"),
               "checkpointed": job("ckpt_cuda", True, "cuda",
                                   "--checkpoint-dir", str(ckpt))}
        segs = sorted(ckpt.glob("gop_*.seg"))
        for seg in segs[1:]:  # as if the run stopped after its first GOP
            seg.unlink()
            seg.with_suffix(".json").unlink()
        first = segs[0].stat().st_mtime_ns
        got["resumed"] = job("ckpt_cuda", True, "cuda", "--checkpoint-dir",
                             str(ckpt))
        if sorted(ckpt.glob("gop_*.seg")) != segs or (
                segs[0].stat().st_mtime_ns != first):
            raise AssertionError("the resumed run did not keep GOP 0 and "
                                 "write the others again")
        for key, files in got.items():
            ref = want["image" if key == "image" else "video"]
            if files != ref:
                raise AssertionError(f"CLI {key}: --device cuda wrote other "
                                     f"files than --device cpu")
            print(f"CLI {key}: {len(files[0])}-byte stream and "
                  f"{len(files[1])}-byte decode, equal to --device cpu",
                  flush=True)
        if np.frombuffer(want["image"][1], np.uint8).size != h * w:
            raise AssertionError("the image decode has the wrong size")


def host_waits(fn, calls: int):
    """The host's waits for the device in each of ``calls`` calls of fn():
    PyTorch's sync debug mode warns at each (a copy to pageable memory, a
    stream's synchronize, a read of a device scalar), and the warnings
    are counted, with the line of Python that waited; it does not see a
    wait on an event, so torch.cuda.Event.synchronize is counted by a
    stand-in that calls it (with the debug mode off meanwhile, so that no
    wait counts twice).  The kernels' C entry points never wait.  Returns
    (waits of each call, {line: waits in all})."""
    import collections
    import os
    import sys as _sys
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    per_call, where = [], collections.Counter()
    event_waits = []
    real_sync = torch.cuda.Event.synchronize

    def counted_sync(event):
        frame = _sys._getframe(1)
        event_waits.append(f"{os.path.basename(frame.f_code.co_filename)}:"
                           f"{frame.f_lineno}")
        torch.cuda.set_sync_debug_mode("default")
        try:
            real_sync(event)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    torch.cuda.Event.synchronize = counted_sync
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(calls):
            event_waits.clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            waits = [w for w in caught if "synchroniz" in str(w.message)]
            per_call.append(len(waits) + len(event_waits))
            where.update(f"{os.path.basename(w.filename)}:{w.lineno}"
                         for w in waits)
            where.update(event_waits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.Event.synchronize = real_sync
    return per_call, dict(where)


def print_profile(label: str, fn, calls: int, absent: tuple = (),
                  waits_wanted: int = 2, at_most: bool = False,
                  d2h_wanted: int | None = None) -> None:
    """Phase 7: device time per call by operation, the number of device
    operations (kernels and copies) per call, the device-to-host copies
    and the host's waits per call.  Fails if a device row's name contains
    one of ``absent``, or if the host waits other than ``waits_wanted``
    times a call (with ``at_most``, more than that in any call): an encode
    (the median of the calls) for the dict table's totals and at the
    stream's own copy, a decode (every call: it leaves its pixels on the
    device) never; or, with ``d2h_wanted``, if the device-to-host copies
    a call are more than it (an encode: its lengths' copy and its bytes'
    one copy, whatever the batch; the profiler may drop records, never
    add them)."""
    counts = {}
    by_op, wall_ms = device_rows(fn, calls, counts)
    for key in by_op:
        if any(a.lower() in key.lower() for a in absent):
            raise AssertionError(f"{label}: the profile has a row {key!r}")
    busy_us = sum(by_op.values())
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    d2h = sum(n for key, n in counts.items() if "DtoH" in key)
    per_call, where = host_waits(fn, calls)
    waits = sorted(per_call)[len(per_call) // 2]
    print(f"profile of {calls} {label} calls: device busy {busy_us:.1f} us "
          f"of {wall_ms * 1e3:.1f} us wall per call, "
          f"{sum(counts.values()):.0f} device operations per call; top "
          f"device items per call: " + "; ".join(
              f"{key[:60]} {us:.1f} us ({counts[key]:.0f}x)"
              for key, us in top), flush=True)
    print(f"{label}: {d2h:.0f} device-to-host copies and {waits:.0f} host "
          f"waits for the device a call (profiler; sync debug mode; median "
          f"of the calls; each call's waits {per_call}, by line {where})",
          flush=True)
    if d2h_wanted is not None and d2h > d2h_wanted + 0.5:
        raise AssertionError(f"{label}: {d2h:g} device-to-host copies a "
                             f"call, expected {d2h_wanted}")
    if at_most and max(per_call) > waits_wanted:
        raise AssertionError(f"{label}: {per_call} host waits a call, "
                             f"expected at most {waits_wanted}")
    if not at_most and (max(per_call) if waits_wanted == 0
                        else waits) != waits_wanted:
        raise AssertionError(f"{label}: {per_call} host waits a call, "
                             f"expected {waits_wanted}")


def host_profile(label: str, fn, top: int = 8) -> None:
    """The host's time in one call of fn() by Python function
    (cProfile, each function's own time): where the host's share of a
    call goes."""
    import cProfile
    import pstats

    import torch

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"{label}: host time by function, one call ({st.total_tt * 1e3:.1f}"
          f" ms under cProfile): " + "; ".join(
              f"{func[2]} ({func[0].split('/')[-1]}:{func[1]}) "
              f"{tt * 1e3:.1f} ms" for func, (_, _, tt, _, _) in rows),
          flush=True)


def keep_row(rows: dict, name: str, key: str, row: dict) -> None:
    """A kernel's row at a phase-9 path's shapes: beside the row of an
    earlier phase, under ``key``, or the row itself where there is none
    (phase 9 run alone)."""
    if name in rows:
        beside(rows[name], key, row)
    else:
        rows[name] = row


def gop_job(reps: int = 0, **kw) -> dict:
    """One process's share of the GOP-distributed encode (run in each
    process of a gloo world, parallel/dryrun.py): its kernels' launches in
    one call (counts from 0); then every kernel call of another call held
    against its plain version (the GOPs' K1, K2, K5, K6+K7 and K4
    pack_coeffs at 4 frames, K3 alone on the spliced stream, the dict and
    K4 pack_payload); then with ``reps`` K3's row at the spliced stream,
    the median host ms of that many calls (a barrier before each), the
    device busy ms of one call under torch.profiler and its host waits.
    Every process makes the same calls in the same order: the calls meet
    in their all-gathers."""
    import torch
    import torch.distributed as dist

    from imageencoder_tpu_torch.parallel import dryrun

    block_host_serialization()
    wrappers = {name: getattr(module(mod_name), attr)
                for name, (mod_name, attr, *_) in KERNELS.items()}
    got = []
    counts = launches_of(wrappers, lambda: got.append(dryrun.job_gops(**kw)))
    out = {"stream": got[0][0], "missing": got[0][1], "counts": counts}
    with captured_calls() as calls:
        dryrun.job_gops(**kw)
    out["held"] = {name: len(c) for name, c in calls.items() if c}
    for name, captured in calls.items():
        for args, kwargs in captured:
            held_equal(name, args, kwargs)
    if reps:
        out["k3_row"] = check_kernel("K3 byte_histogram",
                                     *calls["K3 byte_histogram"][0])
    del calls
    if reps:
        t = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dryrun.job_gops(**kw)
            t.append(time.perf_counter() - t0)
        out["median_ms"] = quantiles(t)[0]
        rows, _ = device_rows(lambda: dryrun.job_gops(**kw), 1)
        out["busy_ms"] = sum(rows.values()) / 1e3 if rows else None
        out["waits"], out["where"] = host_waits(
            lambda: dryrun.job_gops(**kw), 1)
    return out


_PAIR_MESH = {}  # the (1, 2) mesh of a spawned process, made once


def video_pair_job(ref_mode: str, reps: int = 0) -> dict:
    """One process's share of the sharded video in a (1, 2) mesh over gloo
    on the card (run in each process of a gloo world, parallel/dryrun.py):
    encode_video_sharded of the VIDEO_PAIR video (frames on the card,
    Huffman on), every kernel call of one encode held against its plain
    version, and with ``reps`` the median host ms of that many calls (a
    barrier before each), its device busy ms and its host waits.  Every
    process makes the same calls in the same order: they meet in the
    halo exchanges and the all-gathers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch import parallel

    t_job = time.perf_counter()
    block_host_serialization()
    if "mesh" not in _PAIR_MESH:
        _PAIR_MESH["mesh"] = parallel.make_mesh(2, frame_axis=1,
                                                device="cuda")
    mesh = _PAIR_MESH["mesh"]
    w, h, n = VIDEO_PAIR
    frames = torch.from_numpy(video_frames(w, h, n, 2)).cuda()
    quant = port.QuantMatrix(np.array(QUANT, dtype=np.uint32))

    def encode():
        return parallel.encode_video_sharded(frames, quant, mesh, True, GOP,
                                             MERANGE, ref_mode=ref_mode)

    wrappers = {name: getattr(module(mod_name), attr)
                for name, (mod_name, attr, *_) in KERNELS.items()}
    got = []
    out = {"counts": launches_of(wrappers, lambda: got.append(encode()))}
    out["stream"] = got[0]
    with captured_calls() as calls:
        encode()
    out["held"] = {name: len(c) for name, c in calls.items() if c}
    for name, captured in calls.items():
        for args, kwargs in captured:
            held_equal(name, args, kwargs)
    del calls
    if reps:
        t = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode()
            t.append(time.perf_counter() - t0)
        out["median_ms"], out["p90_ms"] = quantiles(t)
        ops = {}
        busy, _ = device_rows(encode, 1, ops)
        out["busy_ms"] = sum(busy.values()) / 1e3 if busy else None
        out["ops"] = sum(ops.values())
        out["waits"], out["where"] = host_waits(encode, 1)
    out["job_s"] = time.perf_counter() - t_job
    return out


def check_sharded_recon_call(counts: dict, where: str) -> None:
    """Fail unless one sharded recon encode launched SHARDED_RECON_CALL."""
    if any(counts[name] != SHARDED_RECON_CALL.get(name, 0)
           for name in KERNELS):
        raise AssertionError(f"one encode_video_sharded recon {where} "
                             f"launched {counts}, expected "
                             f"{SHARDED_RECON_CALL}")


def sharded_video_phase(port, quant, mesh, wrappers, rows: dict) -> list:
    """Phase 9's sharded video in the world of one over NCCL: the 720p25
    video through encode_video_sharded, raw and recon, Huffman on and off,
    every stream equal to the one-device encode_frames on the card (phase
    4 holds that against the plain path), every kernel call of one encode
    held against its plain version and the new kernels' rows kept; the
    launches of each path counted from 0; decode_video_sharded of the
    streams, motion compensation on and off, equal to decode_video; then
    medians, p90s, device and host profiles and waits beside the one-device
    calls.  Returns each path's launch counts."""
    import torch

    from imageencoder_tpu_torch import parallel
    from imageencoder_tpu_torch.models.video import encode_frames

    vw, vh, vn = VIDEO
    frames = torch.from_numpy(video_frames(vw, vh, vn, 0)).cuda()

    def sharded(mode, huff=True):
        return parallel.encode_video_sharded(frames, quant, mesh, True, GOP,
                                             MERANGE, use_huffman=huff,
                                             ref_mode=mode)

    def one(mode, huff=True):
        return encode_frames(frames, vw, vh, quant, True, GOP, MERANGE,
                             use_huffman=huff, ref_mode=mode, device="cuda")

    counts, streams = [], {}
    new = {"raw": "K6+K7 search_residual_stripe",
           "recon": "K6+K7 search_predict_stripe"}
    for mode in ("raw", "recon"):
        with captured_calls() as calls:
            got = sharded(mode)
        held = {name: len(c) for name, c in calls.items() if c}
        for name, captured in calls.items():
            for args, kwargs in captured:
                held_equal(name, args, kwargs)
        rows[new[mode]] = check_kernel(new[mode], *calls[new[mode]][0])
        if mode == "recon":
            # A world of one searches one stripe, the whole frame (row 0,
            # no halo): the whole-frame wrapper's launch, timed beside it.
            args = calls[new[mode]][0][0]
            whole = profiled_ms(lambda: module("cuda_motion").search_predict(
                args[0], args[1], args[5]), "motion_search_kernel")
            rows[new[mode]]["whole_frame_ms"] = whole
            print(f"K6+K7 search_predict on the same frame and reference "
                  f"(the whole-frame wrapper): device {whole:.4f} ms",
                  flush=True)
        if mode == "raw":
            rows["K4 pack_records segments"] = check_kernel(
                "K4 pack_records segments",
                *calls["K4 pack_records segments"][0])
        # The batch packers at this path's shapes: the block segments and
        # the spliced stream's payload.
        for name in ("K2 pack_segments", "K4 pack_payload batch",
                     "wire emit"):
            keep_row(rows, name, f"sharded_video_{mode}",
                     check_kernel(name, *calls[name][0]))
        del calls
        for huff in (True, False):
            streams[mode, huff] = got if huff else sharded(mode, False)
            if streams[mode, huff] != one(mode, huff):
                raise AssertionError(f"encode_video_sharded {mode} (Huffman "
                                     f"{huff}) differs from the one-device "
                                     f"encode_frames")
        print(f"encode_video_sharded {mode} {vw}x{vh}x{vn}, world of one "
              f"over NCCL, Huffman on and off: streams equal to the "
              f"one-device encode_frames on the card; every kernel call of "
              f"one encode bit-equal to its plain version ("
              + ", ".join(f"{name} {n}" for name, n in held.items())
              + " calls)", flush=True)
        one_call = launches_of(wrappers, lambda: sharded(mode))
        print(f"one encode_video_sharded {mode}, Huffman on: " + ", ".join(
            f"{name} {n}" for name, n in one_call.items() if n), flush=True)
        if mode == "recon":
            check_sharded_recon_call(one_call, "in the world of one")
        counts.append(phase_of_path(
            f"sharded video {mode}", wrappers,
            lambda: [sharded(mode, huff) for huff in (True, False)]))
    for (mode, huff), data in streams.items():
        if not huff:
            continue
        for mc in (True, False):
            got = parallel.decode_video_sharded(data, mesh, motioncomp=mc)
            want = port.decode_video(data, mc, device="cuda")
            if got[0] != want[0] or got[2] != want[2]:
                raise AssertionError(f"decode_video_sharded {mode} "
                                     f"motioncomp={mc} differs from "
                                     f"decode_video")
    print(f"decode_video_sharded of the raw and recon streams, motioncomp "
          f"on and off: YUV420 bytes equal to decode_video on the card",
          flush=True)
    raw = streams["raw", True]
    counts.append(phase_of_path(
        "sharded video decode", wrappers,
        lambda: parallel.decode_video_sharded(raw, mesh)))
    mpix = vw * vh * vn / 1e6
    timed = {
        "encode_video_sharded raw": lambda: sharded("raw"),
        "encode_frames raw (one device)": lambda: one("raw"),
        "encode_video_sharded recon": lambda: sharded("recon"),
        "encode_frames recon (one device)": lambda: one("recon"),
        "decode_video_sharded": lambda: parallel.decode_video_sharded(
            raw, mesh),
        "decode_video (one device)": lambda: port.decode_video(
            raw, device="cuda")}
    for label, fn in timed.items():
        t = []
        for _ in range(SHARDED_SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        med, p90 = quantiles(t)
        print(f"{label} {vw}x{vh}x{vn}: median {med:.3f} ms, p90 "
              f"{p90:.3f} ms (n={SHARDED_SAMPLES}; {mpix / med * 1e3:.1f} "
              f"Mpix/s)", flush=True)
        print_profile(label, fn, 3, waits_wanted=20, at_most=True)
        if "sharded" in label:
            host_profile(label, fn)
    return counts


def sharded_phase(port, quant, batch0_d, huff_streams, image_stream,
                  image_pixels, vdata, video_streams, wrappers,
                  rows: dict, t_start: float) -> list:
    """Phase 9: the sharded image encode (Huffman by stage 1 and by the
    distributed stage 2) and the sharded decode in a world of one over
    NCCL, the GOP-distributed video encode in two processes over gloo on
    the card, and the one-process encode_video beside it.  Adds the new
    kernels' rows to ``rows`` (and the rows of earlier kernels at these
    paths' shapes beside theirs); returns each path's launch counts."""
    import numpy as np
    import tempfile

    import torch
    import torch.distributed as dist

    from imageencoder_tpu_torch import parallel
    from imageencoder_tpu_torch.parallel import distributed, dryrun
    from imageencoder_tpu_torch.utils.device import gpu_identity

    print(f"phase 9 gpu: {gpu_identity()}; torch.distributed: nccl "
          f"{dist.is_nccl_available()}, gloo {dist.is_gloo_available()}",
          flush=True)
    if not dist.is_nccl_available():
        raise AssertionError("no NCCL: the sharded paths need it on a card")
    distributed.initialize(device="cuda")
    counts = []
    try:
        mesh = parallel.make_mesh(1, device="cuda")
        bq, bh, bw = batch0_d.shape

        def encode(entropy):
            return parallel.encode_sharded_image_batch(
                batch0_d, quant, mesh, device_entropy=entropy)

        for entropy in (False, True):
            with captured_calls() as calls:
                got = encode(entropy)
            ran = {name: len(c) for name, c in calls.items() if c}
            if ran != SHARDED_CALL[entropy]:
                raise AssertionError(f"one sharded encode (stage 2 "
                                     f"{entropy}) made the calls {ran}")
            for name in ran:
                for args, kwargs in calls[name]:
                    held_equal(name, args, kwargs)
            if entropy:
                rows["K4 pack_payload window"] = check_kernel(
                    "K4 pack_payload window",
                    *calls["K4 pack_payload window"][0])
                for key, k in (("stage2_segments", 0), ("stage2_owned", 1)):
                    beside(rows["K3 byte_histogram_rows"], key, check_kernel(
                        "K3 byte_histogram_rows",
                        *calls["K3 byte_histogram_rows"][k]))
                keep_row(rows, "Huffman dict batch", "sharded_stage2",
                         check_kernel("Huffman dict batch",
                                      *calls["Huffman dict batch"][0]))
                keep_row(rows, "wire emit", "sharded_stage2",
                         check_kernel("wire emit", *calls["wire emit"][0]))
            else:
                # K3 here counts each spliced stream whole.
                for name in ("K2 pack_segments", "K3 byte_histogram_rows"):
                    rows[name] = check_kernel(name, *calls[name][0])
                keep_row(rows, "K4 pack_payload batch", "sharded_stage1",
                         check_kernel("K4 pack_payload batch",
                                      *calls["K4 pack_payload batch"][0]))
                keep_row(rows, "wire emit", "sharded_stage1",
                         check_kernel("wire emit", *calls["wire emit"][0]))
            del calls
            if got != huff_streams:
                bad = [k for k, (a, b) in enumerate(zip(got, huff_streams))
                       if a != b]
                raise AssertionError(f"the sharded encode (stage 2 {entropy})"
                                     f" differs from the one-device batch in "
                                     f"streams {bad}")
            print(f"encode_sharded_image_batch of {bq} {bw}x{bh} images, "
                  f"world of one over NCCL, Huffman by "
                  f"{'the distributed stage 2' if entropy else 'stage 1'}: "
                  f"every stream equal to the one-device batch's (phase 4 "
                  f"held those against the plain path on the host), every "
                  f"kernel call bit-equal to its plain version", flush=True)
        counts.append(phase_of_path("sharded image", wrappers,
                                    lambda: encode(False)))
        counts.append(phase_of_path("sharded image stage 2", wrappers,
                                    lambda: encode(True)))
        decoded = []
        counts.append(phase_of_path(
            "sharded decode", wrappers, lambda: decoded.append(
                parallel.decode_image_sharded(image_stream, mesh))))
        if not torch.equal(decoded[0], image_pixels):
            raise AssertionError("the sharded decode differs from "
                                 "decode_image on the card")
        h, w = image_pixels.shape
        print(f"decode_image_sharded of the {w}x{h} stream, world of one: "
              f"pixel-equal to decode_image on the card (phase 4 held it "
              f"against the plain decode on the host)", flush=True)

        mpix = bq * bh * bw / 1e6
        timed = {
            "encode_sharded_image_batch stage 1": (lambda: encode(False),
                                                   mpix),
            "encode_sharded_image_batch stage 2": (lambda: encode(True),
                                                   mpix),
            "encode_image_batch (one device)": (
                lambda: port.encode_image_batch(batch0_d, quant,
                                                device="cuda"), mpix),
            "decode_image_sharded": (
                lambda: parallel.decode_image_sharded(image_stream, mesh),
                h * w / 1e6),
            "decode_image (one device)": (
                lambda: port.decode_image(image_stream, device="cuda"),
                h * w / 1e6)}
        for label, (fn, mp) in timed.items():
            t = []
            for _ in range(SHARDED_SAMPLES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            med, p90 = quantiles(t)
            print(f"{label}: median {med:.3f} ms, p90 {p90:.3f} ms "
                  f"(n={SHARDED_SAMPLES}; {mp / med * 1e3:.1f} Mpix/s)",
                  flush=True)
            # A decode leaves its pixels on the card: it never waits.
            decode = label.startswith("decode")
            print_profile(label, fn, 3, waits_wanted=0 if decode else 20,
                          at_most=not decode)
            host_profile(label, fn)
        t_video = time.perf_counter()
        print(f"phase 9 sharded video, world of one, starts at "
              f"{t_video - t_start:.1f} s", flush=True)
        counts += sharded_video_phase(port, quant, mesh, wrappers, rows)
        world_one_s = time.perf_counter() - t_video
        print(f"phase 9 sharded video, world of one, done at "
              f"{time.perf_counter() - t_start:.1f} s ({world_one_s:.1f} s)",
              flush=True)
    finally:
        dist.destroy_process_group()

    # The GOP-distributed encode: two processes over gloo, kernels on the
    # card, at 720p25 (timed) and at the small size (held against the
    # plain path on the host).
    vw, vh, vn = VIDEO
    sw, sh, sn = VIDEO_SMALL
    small = yuv420(video_frames(sw, sh, sn, 1))
    base = {"quant": quant, "use_rle": True, "gop": GOP, "merange": MERANGE,
            "device": "cuda"}
    jobs = [("chip_smoke:gop_job", dict(base, data=vdata, width=vw,
                                        height=vh, ref_mode=mode,
                                        reps=GOP_REPS))
            for mode in ("raw", "recon")]
    jobs += [("chip_smoke:gop_job", dict(base, data=small, width=sw,
                                         height=sh, ref_mode=mode))
             for mode in ("raw", "recon")]
    jobs += [("chip_smoke:video_pair_job", {"ref_mode": mode,
                                            "reps": GOP_REPS})
             for mode in ("raw", "recon")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ranks = dryrun.spawn_world(2, jobs, workdir=work, timeout_s=600)
    print(f"two gloo processes on the card: {len(jobs)} jobs in "
          f"{time.perf_counter() - t0:.1f} s (start-up included)", flush=True)
    for k, mode in enumerate(("raw", "recon")):
        for r, res in enumerate(ranks):
            got = res[k]
            if got["missing"] or got["stream"] != video_streams[(mode, True)]:
                raise AssertionError(f"GOP encode {mode}, process {r}: not "
                                     f"the one-process encode_video stream")
            got_s = res[2 + k]
            want = port.encode_video(small, sw, sh, quant, True, GOP, MERANGE,
                                     ref_mode=mode, device="cpu")
            if got_s["missing"] or got_s["stream"] != want:
                raise AssertionError(f"GOP encode {mode} {sw}x{sh}x{sn}, "
                                     f"process {r}: not the plain path's")
        both = {name: sum(res[k]["counts"][name] for res in ranks)
                for name in KERNELS}
        counts.append(check_path(f"gop encode {mode}", both))
        held = {name: sum(res[k]["held"].get(name, 0) for res in ranks)
                for name in KERNELS}
        if any(held[name] < 1 for name in PATHS[f"gop encode {mode}"]):
            raise AssertionError(f"GOP encode {mode}: a kernel of the path "
                                 f"was not held against its plain version "
                                 f"({held})")
        k3 = ranks[0][k]["k3_row"]
        keep_row(rows, "K3 byte_histogram", f"gop_{mode}", k3)
        print(f"GOP encode {mode} {vw}x{vh}x{vn}, two processes: every "
              f"kernel call of one encode bit-equal to its plain version ("
              + ", ".join(f"{name} {n}" for name, n in held.items() if n)
              + f" calls); K3 alone on the spliced stream of {k3['bytes']} "
              f"bytes: device {k3['ms']:.4f} ms (plain {k3['plain_ms']:.4f} "
              f"ms, torch.bincount {k3['library_ms']:.4f} ms), bound "
              f"{k3['bound_ms']:.4f} ms by {k3['bound_by']}", flush=True)
        t = []
        for _ in range(GOP_REPS * 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            port.encode_video(vdata, vw, vh, quant, True, GOP, MERANGE,
                              ref_mode=mode, device="cuda")
            t.append(time.perf_counter() - t0)
        one = quantiles(t)[0]
        r0 = ranks[0][k]
        print(f"GOP-distributed encode_video {mode} {vw}x{vh}x{vn} (gop "
              f"{GOP}, merange {MERANGE}), two processes on one card: stream "
              f"equal to the one-process encode_video on the card (and the "
              f"{sw}x{sh}x{sn} one to the plain path on the host); process "
              f"0: median {r0['median_ms']:.3f} ms a call (n={GOP_REPS}), "
              f"device busy {r0['busy_ms']} ms, host waits {r0['waits']} "
              f"(by line {r0['where']}); process 1: median "
              f"{ranks[1][k]['median_ms']:.3f} ms; one-process encode_video "
              f"median {one:.3f} ms (n={GOP_REPS * 3})", flush=True)
    # The sharded video in a (1, 2) mesh: the halo exchange crosses the
    # two processes.
    from imageencoder_tpu_torch.models.video import encode_frames

    t_checks = time.perf_counter()
    pw, ph, pn = VIDEO_PAIR
    pair_d = torch.from_numpy(video_frames(pw, ph, pn, 2)).cuda()
    for k, mode in enumerate(("raw", "recon")):
        want = encode_frames(pair_d, pw, ph, quant, True, GOP, MERANGE,
                             ref_mode=mode, device="cuda")
        res = [r[4 + k] for r in ranks]
        if any(x["stream"] != want for x in res):
            raise AssertionError(f"the (1, 2) sharded video {mode} differs "
                                 f"from the one-process encode_frames")
        held = {name: sum(x["held"].get(name, 0) for x in res)
                for name in KERNELS}
        both = {name: sum(x["counts"][name] for x in res) for name in KERNELS}
        counts.append(check_path(f"sharded video {mode}", both))
        if mode == "recon":
            for r, x in enumerate(res):
                check_sharded_recon_call(x["counts"], f"in process {r} of "
                                         f"the (1, 2) pair")
        t = []
        for _ in range(GOP_REPS * 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_frames(pair_d, pw, ph, quant, True, GOP, MERANGE,
                          ref_mode=mode, device="cuda")
            t.append(time.perf_counter() - t0)
        print(f"encode_video_sharded {mode} {pw}x{ph}x{pn} on a (1, 2) mesh "
              f"of two gloo processes on the card (two stripes of {ph // 2} "
              f"rows, the halo exchange across the processes): stream equal "
              f"to the one-process encode_frames; every kernel call of one "
              f"encode in each process bit-equal to its plain version ("
              + ", ".join(f"{name} {n}" for name, n in held.items() if n)
              + f" calls); process 0: median {res[0]['median_ms']:.3f} ms, "
              f"p90 {res[0]['p90_ms']:.3f} ms a call (n={GOP_REPS}), device "
              f"busy {res[0]['busy_ms']} ms in {res[0]['ops']:.0f} device "
              f"operations a call, host waits {res[0]['waits']} (by line "
              f"{res[0]['where']}); process 1: median "
              f"{res[1]['median_ms']:.3f} ms, {res[1]['ops']:.0f} device "
              f"operations a call; one-process "
              f"encode_frames median {quantiles(t)[0]:.3f} ms "
              f"(n={GOP_REPS * 3})", flush=True)
    checks_s = time.perf_counter() - t_checks
    pair_s = [max(r[4 + k]["job_s"] for r in ranks) for k in range(2)]
    print(f"phase 9 sharded video: {world_one_s + sum(pair_s) + checks_s:.1f}"
          f" s in all: the world of one {world_one_s:.1f} s, the (1, 2) "
          f"pair's jobs {sum(pair_s):.1f} s (raw {pair_s[0]:.1f}, recon "
          f"{pair_s[1]:.1f} s, the slower process; start-up not included), "
          f"the pair's checks here {checks_s:.1f} s", flush=True)
    print(f"phase 9 video done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return counts


def phase9_alone(port, quant, vdata, dev, t_start: float) -> tuple:
    """``--phase 9``: phase 9 on the inputs the whole run gives it (the
    serving batch and its one-device encode_image_batch streams, the
    3840x2160 Huffman stream and its decode_image pixels, the 720p25
    video's one-process encode_video streams, raw and recon), made by the
    same builders, without the phases that hold those against the plain
    path on the host.  Returns the paths' launch counts; adds the rows."""
    import torch

    block_host_serialization()

    batch_d = torch.from_numpy(serving_batch()).to(dev)
    streams = port.encode_image_batch(batch_d, quant, device="cuda")
    stream = port.encode_image(smoke_images()[1], quant, use_rle=True,
                               use_huffman=True, device="cuda")
    pixels = port.decode_image(stream, device="cuda")
    vw, vh, _ = VIDEO
    videos = {(mode, True): port.encode_video(
        vdata, vw, vh, quant, True, GOP, MERANGE, ref_mode=mode,
        device="cuda") for mode in ("raw", "recon")}
    wrappers = {name: getattr(module(mod_name), attr)
                for name, (mod_name, attr, *_) in KERNELS.items()}
    rows = {}
    counts = sharded_phase(port, quant, batch_d, streams, stream, pixels,
                           vdata, videos, wrappers, rows, t_start)
    return rows, counts


def finish(rows: dict, counts: list, names) -> None:
    """The kernels' rows of ``names`` with their launches in every path's
    run (counts from 0), then the last line."""
    import torch

    for name in names:
        rows[name]["launches"] = sum(c[name] for c in counts)
    print(json.dumps({"kernels": [rows[name] for name in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def dict_histograms() -> dict:
    """{label: (byte counts int64 [256], stream bits)}: the dict kernel's
    hard cases.  Chains of Fibonacci and power-of-two counts (trees as
    deep as their bytes: the serial merge at 30 and 31 bytes, the rounds
    at 33, each through the 15-bit limit), geometric counts up to 2^30,
    few distinct counts, two, one and no byte values, all 256 equal, and
    a refused stream (-1 bits: no dict)."""
    import numpy as np

    rng = np.random.default_rng(11)
    out = {}
    for name, n in (("fibonacci", 30), ("pow2", 31), ("fibonacci", 33)):
        f = np.zeros(256, np.int64)
        a, b = 1, 1
        for i in range(n):
            f[(3 + 7 * i) % 256] = 1 << i if name == "pow2" else a
            a, b = b, a + b
        out[f"{name} chain of {n}"] = f
    out["geometric up to 2^30"] = np.floor(
        2.0 ** rng.uniform(0, 30, 256)).astype(np.int64)
    out["ties"] = rng.choice([0, 1, 2, 3, 8], 256).astype(np.int64)
    out["40 ones, 40 twos"] = np.repeat(np.array([1, 2, 0], np.int64),
                                        [40, 40, 176])
    out["uniform"] = rng.integers(0, 10 ** 6, 256).astype(np.int64)
    out["two byte values"] = np.zeros(256, np.int64)
    out["two byte values"][[3, 200]] = [1, 10 ** 9]
    out["one byte value"] = np.eye(256, dtype=np.int64)[77] * 5
    out["no byte"] = np.zeros(256, np.int64)
    out["all 256 equal"] = np.full(256, 5, np.int64)
    cases = {k: (f, 8 * int(f.sum())) for k, f in out.items()}
    cases["refused"] = (out["ties"], -1)
    return cases


def check_dict_cases(dev) -> None:
    """The dict kernel, one stream and one batch of them all, bit-equal to
    its plain version on dict_histograms()."""
    import numpy as np
    import torch

    cases = dict_histograms()
    hists = torch.from_numpy(np.stack([f for f, _ in cases.values()])
                             .astype(np.int32)).to(dev)
    totals = torch.tensor([t for _, t in cases.values()], dtype=torch.int64,
                          device=dev)
    for k in range(len(cases)):
        held_equal("Huffman dict", (hists[k].clone(), totals[k:k + 1]), {})
    held_equal("Huffman dict batch", (hists, totals), {})
    print(f"Huffman dict: {len(cases)} hard histograms ("
          + ", ".join(cases) + "), one stream each and one batch, "
          f"bit-equal to the plain version", flush=True)


def check_d3_cases(port, image_call, rows: dict) -> None:
    """D3 on the image's records with its payload cut short and with the
    payload off a 16-byte boundary, and on an 8x8 noise image's records
    (its row beside D3's)."""
    import numpy as np
    import torch

    (payload, nbytes, *rest), kwargs = image_call
    cut = torch.full_like(nbytes, 2 * int(nbytes) // 3)
    held_equal("D3 decode_blocks", (payload, cut, *rest), kwargs)
    room = torch.zeros(payload.numel() + 16, dtype=torch.uint8,
                       device=payload.device)
    moved = room[3:3 + payload.numel()]
    moved.copy_(payload)
    held_equal("D3 decode_blocks", (moved, nbytes, *rest), kwargs)
    h, w = SHAPES[0]
    noise = np.random.default_rng(12).integers(0, 256, (h, w),
                                               dtype=np.uint8)
    stream = port.encode_image(noise, port.QuantMatrix(np.ones(
        (8, 8), dtype=np.uint32)), use_rle=False, use_huffman=False,
        block_size=8, device="cuda")
    with captured_calls() as calls:
        port.decode_image(stream, block_size=8, device="cuda")
    if len(calls["D3 decode_blocks"]) != 1:
        raise AssertionError("an 8x8 decode_image did not launch D3 once")
    beside(rows["D3 decode_blocks"], "b8_noise_quant_ones", check_kernel(
        "D3 decode_blocks", *calls["D3 decode_blocks"][0]))
    widest = int(calls["D3 decode_blocks"][0][0][3].max())
    print(f"D3 bit-equal to plain on the 4096x912 image's records with the "
          f"payload cut to two thirds and 3 bytes off a 16-byte boundary, "
          f"and on {w}x{h} noise in 8x8 blocks (fields up to {widest} "
          f"bits)", flush=True)


def main() -> None:
    import numpy as np
    import torch

    alone = sys.argv[1:] == ["--phase", "9"]
    if sys.argv[1:] and not alone:
        raise SystemExit("usage: python3 chip_smoke.py [--phase 9]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one GPU")

    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.models.image import stream_header
    from imageencoder_tpu_torch.models.video import encode_frames
    from imageencoder_tpu_torch.ops.huffman import (huffman_encode_from_hist,
                                                    huffman_launch)
    from imageencoder_tpu_torch.ops.pipeline import make_encode_packed_hist
    from imageencoder_tpu_torch.utils.checkpoint import (
        encode_video_checkpointed)
    from imageencoder_tpu_torch.utils.device import gpu_identity

    dev = torch.device("cuda", 0)
    print(f"gpu: {gpu_identity()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 1. build ----
    t_start = t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")

    quant = port.QuantMatrix(np.array(QUANT, dtype=np.uint32))
    vw, vh, vn = VIDEO
    vframes = video_frames(vw, vh, vn, 0)
    vdata = yuv420(vframes)

    def encode_video(data, w, h, ref_mode, huffman, device="cuda"):
        return port.encode_video(data, w, h, quant, True, GOP, MERANGE,
                                 use_huffman=huffman, ref_mode=ref_mode,
                                 device=device)

    print(f"phase 1 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    if alone:
        rows, counts = phase9_alone(port, quant, vdata, dev, t_start)
        print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        finish(rows, counts, list(rows))
        return

    # ---- 2. each kernel against its plain version, main-path inputs ----
    # No full-size image compresses too little for the dict (the records'
    # headers skew the byte histogram), so the raw-copy fallback runs on a
    # small noise image.
    images = smoke_images()
    noise = np.random.default_rng(9).integers(0, 256, (128, 256),
                                              dtype=np.uint8)
    q_ones = port.QuantMatrix(np.ones((4, 4), dtype=np.uint32))
    full_fallback = np.random.default_rng(11).integers(
        0, 256, FULL_FALLBACK_BYTES, dtype=np.uint8).tobytes()
    with captured_calls() as calls:
        port.encode_image(images[0], quant, use_rle=True, use_huffman=True,
                          device="cuda")
    rows = {}
    for name in IMAGE_CALL:
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"encode_image, expected 1")
        rows[name] = check_kernel(name, *calls[name][0])
    # K2 without the histogram (Huffman off) on the same records.
    rows["K2 pack_locals"] = check_kernel("K2 pack_locals",
                                          *calls["K2 pack_locals+hist"][0])
    del calls
    with captured_calls() as calls:
        fallback = port.encode_image(noise, q_ones, use_rle=True,
                                     use_huffman=True, device="cuda")
    if fallback[0] & 0x80 or len(calls["Huffman dict"]) != 1:
        raise AssertionError("the noise image did not take the fallback "
                             "through one dict launch")
    beside(rows["Huffman dict"], "fallback_image",
           check_kernel("Huffman dict", *calls["Huffman dict"][0]))
    beside(rows["wire emit"], "fallback_image",
           check_kernel("wire emit", *calls["wire emit"][0]))
    del calls
    # A full-size fallback.  No full-size image falls back (the records'
    # headers skew the byte histogram), so a seeded random inner stream of
    # the 4096x912 image's Huffman stream size goes through
    # huffman.huffman_encode, the Huffman entry of a long video's spliced
    # chunks.
    with captured_calls() as calls:
        fallback = module("huffman").huffman_encode(full_fallback, "cuda")
    if (fallback[0] & 0x80 or len(calls["wire emit"]) != 1
            or fallback != module("huffman").huffman_encode(full_fallback,
                                                            "cpu")):
        raise AssertionError("a full-size random stream did not take the "
                             "fallback through one emit, equal to the "
                             "plain path's")
    beside(rows["wire emit"], "fallback_full",
           check_kernel("wire emit", *calls["wire emit"][0]))
    del calls, fallback

    with captured_calls() as calls:
        raw_stream = encode_video(vdata, vw, vh, "raw", True)
    for name in ("K1 encode_locals", "K2 pack_locals+hist", "Huffman dict",
                 "K4 pack_payload", "K6+K7 search_residual", "wire emit"):
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"raw encode_video, expected 1")
    fused = "K6+K7 search_residual"
    rows[fused] = check_kernel(fused, *calls[fused][0])
    # The search and the prediction alone, which no path runs, on the same
    # frames: each P-frame against the frame before it, and the vectors the
    # fused kernel found.
    (fr, gop, merange), _ = calls[fused][0]
    pi = torch.tensor(module("cuda_motion").p_frames(fr.shape[0], gop),
                      device=fr.device)
    cur, ref = fr.index_select(0, pi), fr.index_select(0, pi - 1)
    found = module("cuda_motion").search_residual(fr, gop, merange)[0]
    rows["K6 motion_search"] = check_kernel("K6 motion_search",
                                            (cur, ref, merange), {})
    k7_search = {"video_raw_search": check_kernel("K7 predict",
                                                  (ref, found), {})}
    for name in IMAGE_CALL:  # the same kernels at the video's shapes
        beside(rows[name], "video_raw", check_kernel(name, *calls[name][0]))
    beside(rows["K2 pack_locals"], "video_raw", check_kernel(
        "K2 pack_locals", *calls["K2 pack_locals+hist"][0]))
    if calls["K2 pack_locals+hist"][0][1].get("mvecs") is None:
        raise AssertionError("the raw path gave K2 no vectors")
    del calls, fr, pi, cur, ref, found

    with captured_calls() as calls:
        encode_video(vdata, vw, vh, "recon", True)
    n_p = sum(1 for f in range(vn) if f % GOP)
    for name, want in RECON_CALL.items():
        if len(calls[name]) != want:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"recon encode_video, expected {want}")
        for args, kwargs in calls[name]:
            held_equal(name, args, kwargs)
    # Frame k of every GOP: the calls take views of the frames, every
    # GOP-th one (the I-frames: 7 of them; each step's: 6).
    k5_call = calls["K5 quantize_image"][0]
    if k5_call[0][0].shape[0] != vn - n_p or k5_call[0][0].is_contiguous():
        raise AssertionError(f"K5 took {tuple(k5_call[0][0].shape)} frames, "
                             f"not a view of the {vn - n_p} I-frames")
    rows["K5 quantize_image"] = check_kernel("K5 quantize_image", *k5_call)
    step_args, step_kw = calls["K5 recon_step"][0]
    rows["K5 recon_step"] = check_kernel("K5 recon_step", step_args, step_kw)
    # K5 alone on the P-frame residuals, the input it took before the step
    # was fused.
    cur, pred, *rest = step_args
    beside(rows["K5 quantize_image"], "p_frame_residual", check_kernel(
        "K5 quantize_image", (cur.to(torch.int16) - pred, *rest), {}))
    fused = "K6+K7 search_predict"
    rows[fused] = check_kernel(fused, *calls[fused][0])
    (cur, ref, merange), _ = calls[fused][0]
    found = module("cuda_motion").search_predict(cur, ref, merange)[0]
    beside(rows["K6 motion_search"], "video_recon", check_kernel(
        "K6 motion_search", (cur.contiguous(), ref.contiguous(), merange),
        {}))
    k7_search["video_recon_search"] = check_kernel("K7 predict",
                                                   (ref, found), {})
    for name in ("Huffman dict", "K4 pack_payload", "wire emit"):
        beside(rows[name], "video_recon", check_kernel(name, *calls[name][0]))
    coeffs_call = calls["K4 pack_coeffs+hist"][0]
    rows["K4 pack_coeffs+hist"] = check_kernel("K4 pack_coeffs+hist",
                                               *coeffs_call)
    rows["K4 pack_coeffs"] = check_kernel("K4 pack_coeffs", *coeffs_call)
    # The generic front end on the same records, as [N, F] fields built by
    # the plain glue from the captured coefficients and vectors.
    (coeffs, mvecs, gop, nb, b, rle, _lw, start, n_words), kw = coeffs_call
    if kw.get("lens") is None:
        raise AssertionError("the recon path gave K4 pack_coeffs no lengths")
    # Launch 1 as it runs where no lengths are given (the coefficients'
    # own), launch 2 the same: the same stream.
    beside(rows["K4 pack_coeffs"], "lengths_from_coefficients", check_kernel(
        "K4 pack_coeffs", coeffs_call[0],
        {k: v for k, v in kw.items() if k != "lens"}))
    vals, nbits = module("cuda_pack").coeff_fields(coeffs, mvecs, gop, nb, b,
                                                   rle)
    rows["K4 pack_records"] = check_kernel(
        "K4 pack_records", (vals, nbits, start, n_words),
        {"prefix": kw.get("prefix")})
    print(f"recon encode_video: its 1 K5 ({vn - n_p} I-frames), "
          f"{GOP - 1} recon step and {GOP - 1} K6+K7 search_predict calls "
          f"(frame k of every GOP, {n_p} P-frames), 1 K4 pack_coeffs+hist "
          f"(from the lengths), 1 dict and 1 K4 pack_payload call "
          f"bit-equal to their plain versions", flush=True)
    del calls, step_args, step_kw, cur, pred, rest, coeffs, mvecs, vals
    del nbits, ref, found, coeffs_call, k5_call

    # K3 alone runs where a stream arrives packed: the chunks of a video
    # longer than its passes' frames, spliced on the host.
    lw_, lh_, ln_ = VIDEO_LONG
    long_data = yuv420(video_frames(lw_, lh_, ln_, 3))
    with captured_calls() as calls, chunked_passes():
        encode_video(long_data, lw_, lh_, "raw", True)
    for name in ("K3 byte_histogram", "Huffman dict", "K4 pack_payload"):
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"{ln_}-frame encode_video, expected 1")
    rows["K3 byte_histogram"] = check_kernel("K3 byte_histogram",
                                             *calls["K3 byte_histogram"][0])
    beside(rows["Huffman dict"], "video_long",
           check_kernel("Huffman dict", *calls["Huffman dict"][0]))
    # The emit brings each chunk to the host for the splice, then the
    # Huffman stream.
    for args, kwargs in calls["wire emit"][:-1]:
        held_equal("wire emit", args, kwargs)
    beside(rows["wire emit"], "video_long",
           check_kernel("wire emit", *calls["wire emit"][-1]))
    del calls

    # The decode of the 4096x912 Huffman stream, written on the card.
    h_stream = port.encode_image(images[0], quant, use_rle=True,
                                 use_huffman=True, device="cuda")
    with captured_calls() as calls:
        port.decode_image(h_stream, device="cuda")
    for name in PATHS["image decode"]:
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"decode_image, expected 1")
        rows[name] = check_kernel(name, *calls[name][0])
    for name in PATHS["image decode"][:2]:  # the chains' stats
        rows[name].update(chain_stats(name, *calls[name][0], "image"))
    check_d3_cases(port, calls["D3 decode_blocks"][0], rows)
    del calls

    # The decode of the 720p25 raw stream: K7 alone on its first path.
    with captured_calls() as calls:
        port.decode_frames(raw_stream, device="cuda")
    steps = min(GOP, vn)
    for name, want in (("D1 huffman_decode", 1), ("D2 walk_video", 1),
                       ("vector read", 1), ("D3 decode_blocks", steps),
                       ("K7 predict", steps - 1)):
        if len(calls[name]) != want:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"decode_frames, expected {want}")
        for args, kwargs in calls[name][1:]:
            held_equal(name, args, kwargs)
    beside(rows["D1 huffman_decode"], "video",
           check_kernel("D1 huffman_decode", *calls["D1 huffman_decode"][0]))
    for name in ("D2 walk_video", "vector read", "K7 predict"):
        rows[name] = check_kernel(name, *calls[name][0])
    for key, row in k7_search.items():
        beside(rows["K7 predict"], key, row)
    beside(rows["D3 decode_blocks"], "video_i_frames",
           check_kernel("D3 decode_blocks", *calls["D3 decode_blocks"][0]))
    beside(rows["D3 decode_blocks"], "video_p_frames",
           check_kernel("D3 decode_blocks", *calls["D3 decode_blocks"][1]))
    rows["D1 huffman_decode"]["video"].update(chain_stats(
        "D1 huffman_decode", *calls["D1 huffman_decode"][0], "video"))
    # D1's two paths, each held bit-equal above: the rounds alone and the
    # table after them.
    paths = {rows["D1 huffman_decode"]["chain_breaks_left"],
             rows["D1 huffman_decode"]["video"]["chain_breaks_left"]}
    print(f"D1 breaks left after the rounds: image "
          f"{rows['D1 huffman_decode']['chain_breaks_left']}, video "
          f"{rows['D1 huffman_decode']['video']['chain_breaks_left']} "
          f"(1: the table settled them)", flush=True)
    if paths != {0, 1}:
        raise AssertionError(f"D1 took one path on both streams (breaks "
                             f"left {paths}): the rounds alone and the "
                             f"table are not both held against the plain "
                             f"version")
    rows["D2 walk_video"].update(chain_stats(
        "D2 walk_video", *calls["D2 walk_video"][0], "video"))
    print(f"decode_frames {vw}x{vh}x{vn}: every D1, D2 walk_video, vector "
          f"read, D3 ({steps}) and K7 ({steps - 1}) call bit-equal to its "
          f"plain version", flush=True)
    del calls, k7_search

    # The serving path: one encode_image_batch of 16 images at 4096x912,
    # the last of them noise, then a small batch whose noise image, under
    # quant all ones, does take the fallback.
    bq, bh, bw = BATCHES[0]
    batch0 = serving_batch()
    batch0_d = torch.from_numpy(batch0).to(dev)
    with captured_calls() as calls:
        port.encode_image_batch(batch0_d, quant, device="cuda")
    for name in BATCH_CALL:
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"encode_image_batch, expected 1")
    beside(rows["K1 encode_locals"], "batch",
           check_kernel("K1 encode_locals", *calls["K1 encode_locals"][0]))
    for name in BATCH_CALL[1:-1]:
        rows[name] = check_kernel(name, *calls[name][0])
    beside(rows["wire emit"], "batch",
           check_kernel("wire emit", *calls["wire emit"][0]))
    rows["K2 pack_locals batch"] = check_kernel(
        "K2 pack_locals batch", *calls["K2 pack_locals+hist batch"][0])
    del calls
    fb, fh, fw = FALLBACK_BATCH
    small = np.stack([synthetic(fh, fw, 20 + k) for k in range(fb - 1)]
                     + [np.random.default_rng(9).integers(
                         0, 256, (fh, fw), dtype=np.uint8)])
    with captured_calls() as calls:
        fallback_batch = port.encode_image_batch(small, q_ones, device="cuda")
    kinds = [bool(st[0] & 0x80) for st in fallback_batch]
    if kinds != [True] * (fb - 1) + [False]:
        raise AssertionError(f"the small batch's Huffman flags are {kinds}")
    for name in ("K2 pack_locals+hist batch", "Huffman dict batch",
                 "K4 pack_payload batch", "wire emit"):
        beside(rows[name], "fallback_batch", check_kernel(name,
                                                          *calls[name][0]))
    if fallback_batch != [port.encode_image(im, q_ones, use_huffman=True,
                                            device="cpu") for im in small]:
        raise AssertionError("the small batch differs from the plain path")
    print(f"encode_image_batch of {fb} {fw}x{fh} images, quant all ones: "
          f"the noise image took the fallback inside the batch, every "
          f"stream equal to the plain path", flush=True)
    del calls
    # The emit on the stream's and the checkpointed encode's calls: every
    # one held against its plain version.
    with captured_calls() as calls:
        list(port.encode_image_stream(batch0_d, quant, depth=STREAM_DEPTH,
                                      device="cuda"))
        with tempfile.TemporaryDirectory() as ckpt:
            sw, sh, sn = VIDEO_SMALL
            encode_video_checkpointed(
                yuv420(video_frames(sw, sh, sn, 1)), sw, sh, quant, True,
                GOP, MERANGE, ckpt, device="cuda")
    if len(calls["wire emit"]) < bq + 2:
        raise AssertionError(f"{len(calls['wire emit'])} emits in the stream "
                             f"of {bq} images and a checkpointed encode")
    for args, kwargs in calls["wire emit"]:
        held_equal("wire emit", args, kwargs)
    print(f"encode_image_stream of {bq} images and a checkpointed "
          f"{sw}x{sh}x{sn} encode_video: each of their "
          f"{len(calls['wire emit'])} emits bit-equal to its plain version",
          flush=True)
    del calls
    check_dict_cases(dev)

    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 3. each path, counts from 0 ----
    # From here on the host serialization the emit replaced raises.
    block_host_serialization()
    cases = ([(im, quant, True) for im in images]
             + [(im, quant, False) for im in images]
             + [(noise, q_ones, True)])
    wrappers = {name: getattr(module(mod_name), attr)
                for name, (mod_name, attr, *_) in KERNELS.items()}
    one = launches_of(wrappers, lambda: port.encode_image(
        images[0], quant, use_rle=True, use_huffman=True, device="cuda"))
    if any(one[name] != (name in IMAGE_CALL) for name in KERNELS):
        raise AssertionError(f"one encode_image launched {one}")
    print("one encode_image, Huffman on: " + ", ".join(
        f"{name} {one[name]}" for name in KERNELS), flush=True)
    one = launches_of(wrappers, lambda: encode_video(vdata, vw, vh, "recon",
                                                     True))
    if any(one[name] != RECON_CALL.get(name, 0) for name in KERNELS):
        raise AssertionError(f"one recon encode_video launched {one}, "
                             f"expected {RECON_CALL}")
    print(f"one recon encode_video {vw}x{vh}x{vn}, gop {GOP}, Huffman on: "
          + ", ".join(f"{name} {one[name]}" for name in KERNELS
                      if one[name]) + f" ({sum(RECON_CALL.values()) - 4} "
          f"launches before the pack)", flush=True)
    streams = []
    counts = [phase_of_path("image", wrappers, lambda: streams.extend(
        port.encode_image(im, q, use_rle=True, use_huffman=huff,
                          device="cuda") for im, q, huff in cases))]
    video_streams = {}
    for mode in ("raw", "recon"):
        counts.append(phase_of_path(
            f"video {mode}", wrappers, lambda mode=mode: video_streams.update(
                {(mode, huff): encode_video(vdata, vw, vh, mode, huff)
                 for huff in (True, False)})))
    with chunked_passes():
        counts.append(phase_of_path(
            "video long", wrappers, lambda: video_streams.update(
                {("long", True): encode_video(long_data, lw_, lh_, "raw",
                                              True)})))
    decoded = []
    counts.append(phase_of_path("image decode", wrappers, lambda: decoded.extend(
        port.decode_image(s, device="cuda") for s in streams)))
    n_huff = sum(1 for s in streams if s[0] & 0x80)
    if tuple(counts[-1][name] for name in PATHS["image decode"]) != (
            n_huff, len(streams), len(streams)):
        raise AssertionError(f"{len(streams)} decodes ({n_huff} Huffman) "
                             f"launched {counts[-1]}")
    decoded_videos = {}
    counts.append(phase_of_path(
        "video decode", wrappers, lambda: decoded_videos.update(
            {key: port.decode_frames(s, device="cuda")
             for key, s in video_streams.items()})))
    want = [sum(1 for s in video_streams.values() if s[0] & 0x80),
            len(video_streams), len(video_streams),
            GOP * len(video_streams), (GOP - 1) * len(video_streams)]
    got = [counts[-1][name] for name in PATHS["video decode"]]
    if got != want:  # 4 D3 and 3 K7 a stream at 25 and at 40 frames
        raise AssertionError(f"{len(video_streams)} video decodes launched "
                             f"{got}, expected {want}")
    batches = [(batch0, batch0_d)]
    for b, h, w in BATCHES[1:]:
        imgs = np.stack([synthetic(h, w, 200 + k) for k in range(b)])
        batches.append((imgs, torch.from_numpy(imgs).to(dev)))
    batch_streams = {}

    def drive_batches():
        for imgs, imgs_d in batches:
            for huff in (True, False):
                before = {n: fn.launches for n, fn in wrappers.items()}
                got = port.encode_image_batch(imgs_d, quant,
                                              use_huffman=huff, device="cuda")
                batch_streams[(imgs.shape, huff)] = got
                torch.cuda.synchronize()
                ran = {n: fn.launches - before[n]
                       for n, fn in wrappers.items()
                       if fn.launches != before[n]}
                want = dict.fromkeys(BATCH_CALL if huff else (
                    "K1 encode_locals", "K2 pack_locals batch",
                    "wire emit"), 1)
                if ran != want:
                    raise AssertionError(f"encode_image_batch of "
                                         f"{imgs.shape} (Huffman {huff}) "
                                         f"launched {ran}, expected {want}")
                print(f"one encode_image_batch of {imgs.shape[0]} "
                      f"{imgs.shape[2]}x{imgs.shape[1]} images, Huffman "
                      f"{huff}: " + ", ".join(f"{n} {k}"
                                              for n, k in ran.items()),
                      flush=True)

    counts.append(phase_of_path("image batch", wrappers, drive_batches))
    streamed = []
    counts.append(phase_of_path(
        "image stream", wrappers, lambda: streamed.extend(
            port.encode_image_stream(batch0_d, quant, depth=STREAM_DEPTH,
                                     device="cuda"))))
    if any(counts[-1][name] != bq for name in PATHS["image stream"]):
        raise AssertionError(f"a stream of {bq} images launched {counts[-1]}")
    batch_decoded = []
    huff_streams = batch_streams[(batch0.shape, True)]
    counts.append(phase_of_path(
        "image batch decode", wrappers, lambda: batch_decoded.extend(
            port.decode_image_batch(huff_streams, device="cuda"))))
    if any(counts[-1][name] != bq for name in PATHS["image batch decode"]):
        raise AssertionError(f"decode_image_batch of {bq} streams launched "
                             f"{counts[-1]}")
    for (mode, huff), got in video_streams.items():
        if huff and not got[0] & 0x80:
            raise AssertionError(f"video {mode}: took the raw-copy fallback")
        print(f"video {mode} huffman={huff}: {len(got)} bytes", flush=True)

    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 4. every stream against the port's plain path on the host ----
    for (im, q, huff), got in zip(cases, streams):
        label = f"{im.shape[1]}x{im.shape[0]} huffman={huff}"
        t0 = time.perf_counter()
        want = port.encode_image(im, q, use_rle=True, use_huffman=huff,
                                 device="cpu")
        plain_s = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"{label}: the card's stream differs from "
                                 f"the plain path's ({len(got)} vs "
                                 f"{len(want)} bytes)")
        kind = ("fallback" if huff and not got[0] & 0x80 else
                "huffman" if huff else "raw")
        if huff and (kind == "fallback") != (im is noise):
            raise AssertionError(f"{label}: took the {kind} branch")
        print(f"{label}: {len(got)} bytes ({kind}), byte-identical to the "
              f"plain path on the host ({plain_s:.2f} s there)", flush=True)
    for (im, q, huff), data, got in zip(cases, streams, decoded):
        label = f"{im.shape[1]}x{im.shape[0]} huffman={huff}"
        t0 = time.perf_counter()
        want = port.decode_image(data, device="cpu")
        plain_s = time.perf_counter() - t0
        if got.device != dev or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{label}: the card's decode differs from "
                                 f"the plain path's")
        print(f"{label}: decoded on the card, pixel-equal to the plain path "
              f"on the host ({plain_s:.2f} s there)", flush=True)
    sw, sh, sn = VIDEO_SMALL
    small = yuv420(video_frames(sw, sh, sn, 1))
    for mode in ("raw", "recon"):
        for huff in (True, False):
            label = f"video {mode} {sw}x{sh}x{sn} huffman={huff}"
            got = encode_video(small, sw, sh, mode, huff)
            t0 = time.perf_counter()
            want = encode_video(small, sw, sh, mode, huff, device="cpu")
            plain_s = time.perf_counter() - t0
            if got != want:
                raise AssertionError(f"{label}: the card's stream differs "
                                     f"from the plain path's ({len(got)} vs "
                                     f"{len(want)} bytes)")
            print(f"{label}: {len(got)} bytes, byte-identical to the plain "
                  f"path on the host ({plain_s:.2f} s there)", flush=True)
    for (mode, huff), data in video_streams.items():
        label = f"video decode {mode} huffman={huff}"
        t0 = time.perf_counter()
        want = port.decode_frames(data, device="cpu")
        plain_s = time.perf_counter() - t0
        got = decoded_videos[(mode, huff)]
        if got.device != dev or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{label}: the card's frames differ from "
                                 f"the plain path's")
        print(f"{label}: {tuple(got.shape)} frames decoded on the card, "
              f"equal to the plain path on the host ({plain_s:.2f} s there)",
              flush=True)
    for motioncomp in (True, False):
        label = f"decode_video raw motioncomp={motioncomp}"
        got = port.decode_video(raw_stream, motioncomp, device="cuda")
        t0 = time.perf_counter()
        want = port.decode_video(raw_stream, motioncomp, device="cpu")
        plain_s = time.perf_counter() - t0
        if got[0] != want[0] or got[2] != want[2]:
            raise AssertionError(f"{label}: the card's YUV420 bytes differ "
                                 f"from the plain path's")
        print(f"{label}: {len(got[0])} bytes, equal to the plain path on "
              f"the host ({plain_s:.2f} s there)", flush=True)
    label = f"video raw {lw_}x{lh_}x{ln_} huffman=True (two chunks, K3)"
    t0 = time.perf_counter()
    want = encode_video(long_data, lw_, lh_, "raw", True, device="cpu")
    plain_s = time.perf_counter() - t0
    if video_streams[("long", True)] != want:
        raise AssertionError(f"{label}: the card's stream differs from the "
                             f"plain path's")
    print(f"{label}: {len(want)} bytes, byte-identical to the plain path on "
          f"the host ({plain_s:.2f} s there)", flush=True)
    for imgs, _ in batches:
        for huff in (True, False):
            label = (f"encode_image_batch of {imgs.shape[0]} "
                     f"{imgs.shape[2]}x{imgs.shape[1]} huffman={huff}")
            t0 = time.perf_counter()
            want = port.encode_image_batch(imgs, quant, use_huffman=huff,
                                           device="cpu")
            plain_s = time.perf_counter() - t0
            got = batch_streams[(imgs.shape, huff)]
            if got != want:
                bad = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
                raise AssertionError(f"{label}: streams {bad} differ from "
                                     f"the plain path's")
            flags = sum(1 for st in got if st[0] & 0x80)
            print(f"{label}: {sum(map(len, got))} bytes in all ({flags} "
                  f"Huffman-coded), every stream byte-identical to the plain "
                  f"path on the host ({plain_s:.2f} s there)", flush=True)
    if streamed != huff_streams:
        raise AssertionError("encode_image_stream differs from the batch")
    print(f"encode_image_stream of the {bq} images (depth {STREAM_DEPTH}): "
          f"every stream equal to the batch's, in order", flush=True)
    t0 = time.perf_counter()
    for data, got in zip(huff_streams, batch_decoded):
        want = port.decode_image(data, device="cpu")
        if got.device != dev or not torch.equal(got.cpu(), want):
            raise AssertionError("decode_image_batch differs from the plain "
                                 "decode")
    print(f"decode_image_batch of the {bq} streams: every image on the card, "
          f"pixel-equal to the plain decode on the host "
          f"({time.perf_counter() - t0:.2f} s there)", flush=True)
    del batch_decoded, streamed

    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 5. K1's division beside __ddiv_rn ----
    from imageencoder_tpu_torch.ops.cuda_encode import (
        coeff_bound_bits_residual, division_sweep)

    k_max = 2 ** max(coeff_bound_bits_residual(b, norm) - 1
                     for b in (4, 8) for norm in ("reference", "ortho"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = division_sweep(dev, k_max, DIV_RANDOM, seed=2024)
    sweep_s = time.perf_counter() - t0
    want_checks = 255 * ((2 * k_max + 1) * 51 + DIV_RANDOM)
    if sweep["checks"] != want_checks or sweep["mismatches"]:
        raise AssertionError(f"division sweep: {sweep} ({want_checks} "
                             f"checks expected)")
    print(f"division sweep: K1's reciprocal division equals __ddiv_rn in all "
          f"{sweep['checks']} checks (q 1..255; |k| <= {k_max} at k*q, "
          f"(k+1/2)*q, (k+1/4)*q +-8 ulps; {DIV_RANDOM} random y), "
          f"{sweep_s:.2f} s", flush=True)

    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 6. timing ----
    for (hh, ww), im in zip(SHAPES, images):
        mpix = hh * ww / 1e6
        t = []
        for _ in range(SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img_d = torch.from_numpy(im).to(dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        h2d = quantiles(t)

        sb, hdr = stream_header(quant, True, ww, hh, True, dev)
        qf = quant.as_float()
        enc = make_encode_packed_hist(4, True, "reference")
        packed = enc(img_d, qf, sb, hdr)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(SAMPLES)]
        for start, end in ev:
            start.record()
            enc(img_d, qf, sb, hdr)
            end.record()
        torch.cuda.synchronize()
        dev_enc = quantiles([s.elapsed_time(e) / 1e3 for s, e in ev])
        busy = profiled_ms(lambda: enc(img_d, qf, sb, hdr))

        t = []
        for _ in range(SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            huffman_encode_from_hist(*packed)
            t.append(time.perf_counter() - t0)
        huff = quantiles(t)
        tail_ms = time_tail(lambda: huffman_launch(*packed))

        t = []
        for _ in range(SAMPLES):
            t0 = time.perf_counter()
            port.encode_image(img_d, quant, use_huffman=True, device="cuda")
            t.append(time.perf_counter() - t0)
        e2e = quantiles(t)
        print(f"{ww}x{hh}: device encode K1+K2 (with the histogram) median "
              f"{dev_enc[0]:.4f} ms, p90 {dev_enc[1]:.4f} ms (n={SAMPLES}; "
              f"{mpix / dev_enc[0] * 1e3:.1f} Mpix/s), of which device busy "
              f"{busy:.4f} ms; Huffman stage (huffman_encode_from_hist: the "
              f"dict, K4, the wait and the copies) median {huff[0]:.3f} ms, "
              f"p90 {huff[1]:.3f} ms; encode_image "
              f"with Huffman, image on device: median {e2e[0]:.3f} ms, p90 "
              f"{e2e[1]:.3f} ms (n={SAMPLES}; "
              f"{mpix / e2e[0] * 1e3:.1f} Mpix/s); H2D copy median "
              f"{h2d[0]:.3f} ms, p90 {h2d[1]:.3f} ms (n={SAMPLES}); "
              f"{tail_ms}", flush=True)
    for (hh, ww), im in zip(SHAPES, images):
        time_decode(port.encode_image(im, quant, use_rle=True,
                                      use_huffman=True, device="cuda"),
                    hh, ww, dev)
    for mode in ("raw", "recon"):
        time_video(vframes, quant, mode, dev)
    time_video_decode(raw_stream, vn, vh, vw, dev)
    serving_streams = time_serving(batch0_d, quant, dev)

    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 7. where the device time goes ----
    # An encode waits for its dict table's totals, then for its stream's
    # copy unless that has landed by the time the host looks: at most 2.
    img_d = torch.from_numpy(images[0]).to(dev)
    print_profile(f"encode_image at {SHAPES[0][1]}x{SHAPES[0][0]}",
                  lambda: port.encode_image(img_d, quant, use_huffman=True,
                                            device="cuda"), PROFILE_CALLS,
                  at_most=True, d2h_wanted=2)
    fr_d = torch.from_numpy(vframes).to(dev)
    for mode, absent in (("raw", ("predict_kernel", "scan")),
                         ("recon", ("predict_kernel",))):
        print_profile(
            f"encode_video {mode} at {vw}x{vh}x{vn}",
            lambda mode=mode: encode_frames(
                fr_d, vw, vh, quant, True, GOP, MERANGE, use_huffman=True,
                ref_mode=mode, device=dev), VIDEO_PROFILE_CALLS, absent,
            at_most=True, d2h_wanted=2)

    print_profile(f"decode_image at {SHAPES[0][1]}x{SHAPES[0][0]}",
                  lambda: port.decode_image(h_stream, device="cuda"),
                  PROFILE_CALLS, waits_wanted=0)
    print_profile(f"decode_frames at {vw}x{vh}x{vn}",
                  lambda: port.decode_frames(raw_stream, device="cuda"),
                  VIDEO_PROFILE_CALLS, waits_wanted=0)
    print_profile(f"decode_video at {vw}x{vh}x{vn}",
                  lambda: port.decode_video(raw_stream, device="cuda"),
                  VIDEO_PROFILE_CALLS, waits_wanted=1)
    # Serving: the batch waits once for its lengths and once for its
    # copies, whatever B; the stream once an image and once at its end;
    # the batch decode never.
    print_profile(f"encode_image_batch of {bq} at {bw}x{bh}",
                  lambda: port.encode_image_batch(batch0_d, quant,
                                                  device="cuda"),
                  VIDEO_PROFILE_CALLS, at_most=True, d2h_wanted=2)
    print_profile(f"encode_image_stream of {bq} at {bw}x{bh}",
                  lambda: list(port.encode_image_stream(
                      batch0_d, quant, depth=STREAM_DEPTH, device="cuda")),
                  VIDEO_PROFILE_CALLS, waits_wanted=bq + 1, at_most=True,
                  d2h_wanted=2 * bq)
    print_profile(f"decode_image_batch of {bq} at {bw}x{bh}",
                  lambda: port.decode_image_batch(serving_streams,
                                                  device="cuda"),
                  VIDEO_PROFILE_CALLS, waits_wanted=0)

    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 8. the command line ----
    cli_phase(images[0], video_frames(sw, sh, sn, 1))

    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 9. the sharded and multi-process paths ----
    counts += sharded_phase(
        port, quant, batch0_d, huff_streams, streams[1], decoded[1], vdata,
        video_streams, wrappers, rows, t_start)

    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    finish(rows, counts, KERNELS)


if __name__ == "__main__":
    main()
