"""The port's glue on the CPU: ``python -m imageencoder_tpu_torch`` (cli.py)
against the JAX package's CLI with ``--backend numpy``, both run in this
process, file for file; its exit codes and ``--trace`` table; the copies
of ConfigReader, QuantMatrix.from_file, the metrics and the Logger; the
profiling scopes and device trace; and the checkpointed GOP encode
(utils/checkpoint.py) against a straight encode_video, on resume, on
damaged segments, on another job's directory and on a directory the JAX
package wrote.

Every job writes its own raw files and matrix.txt: the reference's
fixtures are not needed."""

import json
import pathlib

import numpy as np
import pytest

import torch

from imageencoder_tpu import cli as jax_cli
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.utils import checkpoint as jax_checkpoint
from imageencoder_tpu.utils import config as jax_config
from imageencoder_tpu.utils import logger as jax_logger
from imageencoder_tpu.utils import metrics as jax_metrics
from imageencoder_tpu.utils.quant import QuantMatrix as JaxQuant
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch import cli
from imageencoder_tpu_torch.utils import (checkpoint, config, logger, metrics,
                                          profiling)
from imageencoder_tpu_torch.utils.quant import QuantMatrix

MATRIX = "16 11 10 16\n12 12 14 19\n14 13 16 24\n14 17 22 29\n"


def video_frames(w: int, h: int, n: int, seed: int) -> np.ndarray:
    """8x8 random blocks moving by (2, 3) pixels a frame, plus noise."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    return np.stack([np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                             + rng.normal(0, 3, base.shape), 0, 255)
                     .astype(np.uint8) for f in range(n)])


def yuv420(frames) -> bytes:
    h, w = frames.shape[1:]
    return b"".join(f.tobytes() + bytes([0x80]) * (w * h // 2)
                    for f in frames)


def write_conf(path: pathlib.Path, **keys) -> pathlib.Path:
    path.write_text("".join(f"{k}={v}\n" for k, v in keys.items()))
    return path


def write_job(d: pathlib.Path, kind: str, big: bool = False):
    """An image job ("image") or a video encoder job with a decoder's
    decfile ("video") in ``d``: (config path, [the files it writes]).  The
    raw input is seeded; ``big`` takes the card's sizes."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "matrix.txt").write_text(MATRIX)
    enc, dec = d / "out.enc", d / "out_dec.raw"
    if kind == "image":
        h, w = (912, 4096) if big else (96, 128)
        rng = np.random.default_rng(3)
        y, x = np.mgrid[0:h, 0:w]
        img = np.clip(128 + 60 * np.sin(x / 9.0) * np.cos(y / 7.0)
                      + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
        img.tofile(d / "in.raw")
        conf = write_conf(d / "job.conf", rawfile=d / "in.raw", encfile=enc,
                          decfile=dec, rle=1, quantfile=d / "matrix.txt",
                          width=w, height=h, logfile=d / "job.log")
    else:
        w, h, n = (320, 176, 8) if big else (64, 48, 7)
        (d / "in.yuv").write_bytes(yuv420(video_frames(w, h, n, 4)))
        conf = write_conf(d / "job.conf", rawfile=d / "in.yuv", encfile=enc,
                          decfile=dec, rle=1, quantfile=d / "matrix.txt",
                          width=w, height=h, gop=3, merange=8,
                          logfile=d / "job.log")
    return conf, [enc, dec]


def both_clis(tmp_path, kind: str, *flags: str):
    """The files each CLI writes for one job: (port's, JAX package's)."""
    outs = []
    for name, main, dev_flags in (
            ("port", cli.main, ("--device", "cpu")),
            ("jax", jax_cli.main, ("--backend", "numpy"))):
        conf, files = write_job(tmp_path / name, kind)
        assert main([str(conf), *dev_flags, *flags]) == 0
        outs.append([f.read_bytes() for f in files])
    return outs


@pytest.mark.parametrize("flags", [(), ("--no-huffman",)])
def test_image_job_writes_the_jax_clis_files(tmp_path, flags):
    got, want = both_clis(tmp_path, "image", *flags)
    assert got == want
    assert len(got[1]) == 96 * 128
    assert bool(got[0][0] & 0x80) == (not flags)


@pytest.mark.parametrize("flags", [(), ("--ref-mode", "recon"),
                                   ("--no-huffman",)])
def test_video_job_writes_the_jax_clis_files(tmp_path, flags):
    got, want = both_clis(tmp_path, "video", *flags)
    assert got == want
    assert len(got[1]) == 7 * 64 * 48 * 3 // 2


def test_video_decode_job_writes_the_jax_clis_file(tmp_path):
    """A decoder-schema config (encfile, decfile, motioncompensation) on
    the stream the JAX CLI wrote."""
    conf, (enc, _) = write_job(tmp_path / "enc", "video")
    assert jax_cli.main([str(conf), "--backend", "numpy",
                         "--mode", "encode"]) == 0
    outs = []
    for name, main, flags in (("port", cli.main, ("--device", "cpu")),
                              ("jax", jax_cli.main, ("--backend", "numpy"))):
        for mc in (1, 0):
            dec = tmp_path / f"{name}{mc}.yuv"
            job = write_conf(tmp_path / f"{name}{mc}.conf", encfile=enc,
                             decfile=dec, motioncompensation=mc)
            assert main([str(job), *flags]) == 0
            outs.append(dec.read_bytes())
    assert outs[:2] == outs[2:] and outs[0] != outs[1]


def test_checkpointed_video_job_writes_the_jax_clis_files(tmp_path):
    got, want = both_clis(tmp_path, "video", "--checkpoint-dir",
                          str(tmp_path / "ckpt"))
    assert got == want
    assert len(list((tmp_path / "ckpt").glob("gop_*.seg"))) == 3


def test_exit_codes(tmp_path, capsys):
    conf, _ = write_job(tmp_path / "v", "video")
    assert cli.main([str(tmp_path / "missing.conf"), "--device", "cpu"]) == 2
    bad = write_conf(tmp_path / "bad.conf", rawfile="x", gop=1)
    assert cli.main([str(bad), "--device", "cpu"]) == 3
    dup = tmp_path / "dup.conf"
    dup.write_text("encfile=a\nencfile=b\n")
    assert cli.main([str(dup), "--device", "cpu"]) == 2
    vdec = write_conf(tmp_path / "vdec.conf", encfile="a.enc",
                      decfile="a.yuv", motioncompensation=1)
    assert cli.main([str(vdec), "--device", "cpu", "--mode", "encode"]) == 3
    nodec = write_conf(tmp_path / "nodec.conf",
                       **{k: v for k, v in config_values(conf).items()
                          if k != "decfile"})
    assert cli.main([str(nodec), "--device", "cpu", "--mode", "decode"]) == 4
    missing = write_conf(tmp_path / "missing_raw.conf",
                         **{**config_values(conf),
                            "rawfile": tmp_path / "absent.yuv"})
    assert cli.main([str(missing), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "Error reading file" in err and "Error in settings!" in err
    assert "no decfile" in err and "absent.yuv" in err


def test_a_raw_file_of_the_wrong_size_exits_1(tmp_path, capsys):
    conf, _ = write_job(tmp_path, "image")
    (tmp_path / "in.raw").write_bytes(b"\0" * 100)
    assert cli.main([str(conf), "--device", "cpu"]) == 1
    assert "Cannot read file" in capsys.readouterr().err


def test_cuda_without_a_card_exits_1_and_decodes_nothing(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf, files = write_job(tmp_path, "image")
    assert cli.main([str(conf), "--device", "cuda"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not any(f.exists() for f in files)


def config_values(path) -> dict:
    c = config.ConfigReader()
    assert c.read(str(path))
    return dict(c.values)


def test_trace_prints_the_stage_table(tmp_path, capsys):
    conf, _ = write_job(tmp_path, "image")
    assert cli.main([str(conf), "--device", "cpu", "--trace"]) == 0
    err = capsys.readouterr().err
    for line in ("[trace:image encode] device encode+pack+hist:",
                 "[trace:image encode] huffman:",
                 "[trace:image decode] parse:",
                 "[trace:image decode] device decode:",
                 "[trace:image encode] total:", "Mpix/s"):
        assert line in err
    log = (tmp_path / "job.log").read_text()
    assert "[trace:image decode] total:" in log
    assert "[ImageEncoder] Encoded size:" in log


def test_the_two_clis_keep_their_own_logs(tmp_path):
    """The port's Logger is its own class: in one process each CLI's log
    lines land in its own file only."""
    got = both_clis(tmp_path, "image")
    assert got[0] == got[1]
    port_log = (tmp_path / "port" / "job.log").read_text()
    jax_log = (tmp_path / "jax" / "job.log").read_text()
    assert port_log.count("[ImageEncoder] Processing image...") == 1
    assert jax_log.count("[ImageEncoder] Processing image...") == 1
    assert logger.Logger is not jax_logger.Logger
    jax_logger.Logger.close()


CONFIGS = {
    "image": "rawfile=a\nencfile=b\ndecfile=c\nrle=1\nquantfile=m\n"
             "width=8\nheight=8\nlogfile=\n",
    "video-encode": "rawfile=a\nencfile=b\nrle=0\nquantfile=m\nwidth=16\r\n"
                    "height=16\ngop=4\nmerange=8\n\n",
    "video-decode": "encfile=b\ndecfile=c\nmotioncompensation=0\n",
    "mixed": "rawfile=a\nencfile=b\ndecfile=c\nrle=1\nquantfile=m\n"
             "width=8\nheight=8\nlogfile=\ngop=1\n",
    "extra": "encfile=b\ndecfile=c\nmotioncompensation=0\ncolor=1\n",
    "no equals": "encfile=b\ndecfile\n",
    "empty key": "=b\n",
    "duplicate": "gop=1\ngop=2\n",
    "empty": "",
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_reader_equals_the_original(tmp_path, name):
    path = tmp_path / "c.conf"
    path.write_text(CONFIGS[name])
    got, want = config.ConfigReader(), jax_config.ConfigReader()
    assert got.read(str(path)) == want.read(str(path))
    assert got.values == want.values and got.error == want.error
    assert got.detect_mode() == want.detect_mode()
    assert got.error == want.error
    assert got.read(str(tmp_path / "absent")) is False
    assert got.error == "Can't open file"


MATRICES = {
    "4x4": (MATRIX, 4), "hex and blank lead": ("\n\n0x10 2 3 4\n" * 4, 4),
    "8x8": ("".join(" ".join(str(1 + i + j) for j in range(8)) + "\n"
                    for i in range(8)), 8),
    "extra rows": (MATRIX + "1 2 3 4\n", 4), "short row": ("1 2 3\n", 4),
    "few rows": ("1 2 3 4\n", 4), "too wide": ("70000 1 1 1\n" * 4, 4),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_quant_from_file_equals_the_original(tmp_path, name):
    text, size = MATRICES[name]
    path = tmp_path / "matrix.txt"
    path.write_text(text)
    try:
        want = JaxQuant.from_file(str(path), size=size).matrix
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            QuantMatrix.from_file(str(path), size=size)
        return
    got = QuantMatrix.from_file(str(path), size=size)
    np.testing.assert_array_equal(got.matrix, want)
    assert got.matrix.dtype == want.dtype


def test_metrics_equal_the_originals():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (16, 16))
    b = np.clip(a + rng.integers(-3, 4, a.shape), 0, 255)
    for fn in ("psnr", "compression_ratio", "mpix_per_s"):
        args = {"psnr": (a, b), "compression_ratio": (123, 4567),
                "mpix_per_s": (4096 * 912, 0.0025)}[fn]
        assert getattr(metrics, fn)(*args) == getattr(jax_metrics, fn)(*args)
    assert metrics.psnr(a, a) == float("inf")


def test_tracing_scopes_and_device_trace(tmp_path):
    assert profiling.current() is None
    img = np.random.default_rng(1).integers(0, 256, (32, 48), np.uint8)
    q = port.quant_from_numpy(np.array([[16] * 4] * 4))
    with profiling.tracing("outer", pixels=32 * 48) as t:
        assert profiling.current() is t
        with profiling.device_trace(str(tmp_path / "trace")) as prof:
            port.encode_image(img, q, use_huffman=True, device="cpu")
        assert prof is not None
    assert profiling.current() is None
    assert [label for label, _ in t.stages] == ["device encode+pack+hist",
                                                "huffman", "tobytes"]
    assert [parent for *_, parent in t.records] == [-1, -1, 1]
    top = [dt for (_, dt), r in zip(t.stages, t.records) if r[3] < 0]
    assert t.total >= sum(top) > 0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


# ---- the checkpointed GOP encode ----

W, H, N, GOP, MERANGE = 64, 48, 8, 3, 8


def job_data() -> bytes:
    return yuv420(video_frames(W, H, N, 5))


def ckpt(d, use_huffman=True, ref_mode="raw", merange=MERANGE):
    return checkpoint.encode_video_checkpointed(
        job_data(), W, H, port.quant_from_numpy(np.array(
            [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
             [14, 17, 22, 29]])), True, GOP, merange, str(d),
        use_huffman=use_huffman, ref_mode=ref_mode, device="cpu")


def straight(use_huffman=True, ref_mode="raw"):
    q = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]
    got = port.encode_video(job_data(), W, H, port.quant_from_numpy(q),
                            True, GOP, MERANGE, use_huffman=use_huffman,
                            ref_mode=ref_mode, device="cpu")
    want = jax_video.encode_video(job_data(), W, H, JaxQuant(np.array(
        q, np.uint32)), True, GOP, MERANGE, use_huffman=use_huffman,
        backend="numpy", ref_mode=ref_mode)
    assert got == bytes(want)
    return got


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
@pytest.mark.parametrize("use_huffman", [True, False])
def test_checkpointed_encode_equals_encode_video(tmp_path, ref_mode,
                                                 use_huffman):
    got = ckpt(tmp_path, use_huffman, ref_mode)
    assert got == straight(use_huffman, ref_mode)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["backend"] == "numpy" and meta["frames"] == N
    assert sorted(p.name for p in tmp_path.glob("gop_*")) == [
        f"gop_{i:06d}.{ext}" for i in range(3) for ext in ("json", "seg")]


def test_resume_after_a_partial_run(tmp_path, monkeypatch):
    want = ckpt(tmp_path)
    kept = (tmp_path / "gop_000000.seg").read_bytes()
    for i in (1, 2):  # as if the run stopped after its first GOP
        (tmp_path / f"gop_{i:06d}.seg").unlink()
        (tmp_path / f"gop_{i:06d}.json").unlink()
    calls = []
    real = checkpoint.to_device
    monkeypatch.setattr(checkpoint, "to_device",
                        lambda *a: calls.append(1) or real(*a))
    assert ckpt(tmp_path) == want
    assert calls == [1]  # the frames went up once, for the two GOPs
    assert (tmp_path / "gop_000000.seg").read_bytes() == kept


@pytest.mark.parametrize("damage", ["flip", "truncate", "bad json"])
def test_a_damaged_segment_is_encoded_again(tmp_path, damage):
    want = ckpt(tmp_path)
    seg, info = tmp_path / "gop_000001.seg", tmp_path / "gop_000001.json"
    good = seg.read_bytes()
    if damage == "flip":
        seg.write_bytes(bytes([good[0] ^ 1]) + good[1:])
    elif damage == "truncate":
        seg.write_bytes(good[:-1])
    else:
        info.write_text("{")
    assert ckpt(tmp_path) == want
    assert seg.read_bytes() == good


def test_another_jobs_directory_is_refused(tmp_path):
    ckpt(tmp_path)
    with pytest.raises(ValueError, match="different job"):
        ckpt(tmp_path, merange=4)
    with pytest.raises(ValueError, match="different job"):
        ckpt(tmp_path, ref_mode="recon")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_directory_the_other_package_wrote_resumes(tmp_path, monkeypatch,
                                                     writer):
    q = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]], np.uint32)

    def jax_run():
        return bytes(jax_checkpoint.encode_video_checkpointed(
            job_data(), W, H, JaxQuant(q), True, GOP, MERANGE,
            str(tmp_path), backend="numpy"))

    first, second = (jax_run, lambda: ckpt(tmp_path)) if writer == "jax" \
        else (lambda: ckpt(tmp_path), jax_run)
    want = first()
    segs = {p.name: p.read_bytes() for p in tmp_path.glob("gop_*")}
    if writer == "jax":  # the port resumes without encoding a GOP
        monkeypatch.setattr(checkpoint, "to_device", None)
    assert second() == want == straight()
    assert {p.name: p.read_bytes() for p in tmp_path.glob("gop_*")} == segs
