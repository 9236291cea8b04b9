"""The check that decides ``correct``: a run of each tiny cell drives the
port's plain path on the CPU (the harness's look for a card is skipped),
and comes out correct; with the timed path broken underneath, each fault
the cell can have makes it come out not correct; and so does the control,
the reference in the program's place with its transforms in float32."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

from conftest import CELLS, run_tiny

BENCH = harness.spec()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    check = result["checks"]
    value = next(v for k, v in check.items() if k.startswith("mismatched"))
    assert value == {"value": 0, "limit": 0}
    assert set(result["metrics"]) == {
        m["name"] for m in harness.metrics_for(BENCH["end_to_end"], name)}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_its_layers(name):
    result = run_tiny(name, trace=True)
    assert result["correct"] is True
    span = {"image_ex4.batch16": "copy_ms.encode_batch",
            "video_720p_gop4.decode": "parse_ms.decode_video",
            "video_720p_gop4.encode": "launch_ms.encode"}[name]
    assert result["metrics"][span]["value"] > 0
    assert "setup_s" not in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_byte(out):
    """A stream (or the first of a batch's) with one byte flipped."""
    if isinstance(out, list):
        return [_alter_byte(out[0])] + out[1:]
    return out[:len(out) // 2] + bytes([out[len(out) // 2] ^ 1]) + \
        out[len(out) // 2 + 1:]


def _altered(wl):
    port = wl.port_program()
    return lambda inp: _alter_byte(port(inp))


def _half_batch(wl):
    """Half of the batch encoded; its streams stand for the rest."""
    port = wl.port_program()

    def run(imgs):
        half = port(imgs[:len(imgs) // 2])
        return half + half
    return run


def _unchanged(wl):
    """Every request returns the first request's output."""
    port = wl.port_program()
    first = []

    def run(inp):
        if not first:
            first.append(port(inp))
        return first[0]
    return run


def _pixel(wl):
    port = wl.port_program()

    def run(data):
        out = port(data).clone()
        out[-1, 0, 0] ^= 1
        return out
    return run


def _no_residual(wl):
    """The P-frames left as their prediction: the residual's step skipped
    (the port's own decode without motion compensation)."""
    from imageencoder_tpu_torch import decode_frames

    return lambda data: decode_frames(data, False, device="cpu")


def _half_frames(wl):
    port = wl.port_program()

    def run(data):
        out = port(data).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return run


FAULTS = [("image_ex4.batch16", _altered), ("image_ex4.batch16", _half_batch),
          ("image_ex4.batch16", _unchanged),
          ("video_720p_gop4.encode", _altered),
          ("video_720p_gop4.encode", _unchanged),
          ("video_720p_gop4.decode", _pixel),
          ("video_720p_gop4.decode", _no_residual),
          ("video_720p_gop4.decode", _half_frames)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_fault_is_not_correct(name, fault):
    result = run_tiny(name, program=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("name,sizes", [
    ("image_ex4.batch16", {}),
    ("video_720p_gop4.encode", {}),
    # A decode's float32 inverse rounds a pixel otherwise only now and
    # then: 25 frames at 176x144 flip a few in each clip.
    ("video_720p_gop4.decode", {"width": 176, "height": 144,
                                "frame_count": 25, "clips": 2}),
])
def test_control_is_not_correct(name, sizes):
    result = run_tiny(name, program=lambda wl: wl.control_program(),
                      **sizes)
    assert result["correct"] is False
    check = next(v for k, v in result["checks"].items()
                 if k.startswith("mismatched"))
    assert check["value"] > check["limit"]


def test_seed_fixes_the_inputs_and_their_order():
    from benchmark import workload

    from conftest import tiny

    def draws(seed):
        _, config, traffic, _ = tiny("image_ex4.batch16")
        wl = workload.make(config, traffic, seed, "cpu")
        wl.make_inputs()
        return wl.pool, [wl.draw()[0] for _ in range(20)]

    pool_a, order_a = draws(2 ** 33 + 1)
    pool_b, order_b = draws(2 ** 33 + 1)
    pool_c, order_c = draws(2 ** 33 + 2)
    assert torch.equal(pool_a, pool_b) and order_a == order_b
    assert not torch.equal(pool_a, pool_c) and order_a != order_c
