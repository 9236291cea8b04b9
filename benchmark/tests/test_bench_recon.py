"""The recon cell's check, on its tiny version (64x48, 6 frames, gop 6,
merange 32) through the port's plain path on the CPU: a sound run is
correct and its traced run reports the ``recon`` span; a stream with a
byte flipped, the port's raw-reference stream, and the control (the
reference with its transforms in float32) each come out not correct."""

from __future__ import annotations

from conftest import run_tiny

CELL = "video_720p_gop6_me32_recon.encode_recon"


def _flipped(wl):
    port = wl.port_program()

    def run(frames):
        out = port(frames)
        i = len(out) // 2
        return out[:i] + bytes([out[i] ^ 1]) + out[i + 1:]
    return run


def _raw_reference(wl):
    """The port's raw-reference encode: every P-frame predicted from the
    raw frame before it, not its reconstruction."""
    from imageencoder_tpu_torch.models.video import encode_frames
    from benchmark.workload import quant_matrix

    c = wl.config
    return lambda frames: encode_frames(
        frames, wl.w, wl.h, quant_matrix(wl.quant), c["use_rle"], c["gop"],
        c["merange"], c["use_huffman"], c["norm"], "raw", c["block_size"],
        device="cpu")


def _control(wl):
    return wl.control_program()


def test_sound_run_is_correct_and_traced_reports_recon():
    result = run_tiny(CELL, trace=True)
    assert result["correct"] is True
    assert result["metrics"]["recon_ms.encode_video"]["value"] > 0
    assert result["checks"]["mismatched_streams"] == {"value": 0,
                                                      "limit": 0}


def _not_correct(program):
    result = run_tiny(CELL, program=program)
    assert result["correct"] is False
    assert result["checks"]["mismatched_streams"]["value"] >= 1
    return result


def test_flipped_byte_is_not_correct():
    _not_correct(_flipped)


def test_raw_reference_stream_is_not_correct():
    _not_correct(_raw_reference)


def test_control_is_not_correct():
    _not_correct(_control)
