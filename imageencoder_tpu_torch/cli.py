"""Config-driven CLI of the port, drop-in compatible with the reference's
main.cpp.

Usage:  python -m imageencoder_tpu_torch <settings.conf>
        [--mode encode|decode|both] [--device cuda|cpu] [--no-huffman]
        [--ref-mode raw|recon] [--checkpoint-dir DIR] [--trace] ...

The counterpart of imageencoder_tpu/cli.py, with its schema, its mode
detection (main.cpp:34-52) and its exit codes: 2 for an unreadable
config, 3 for an invalid one or for an encode of a decode job, 4 for a
decode-only run without a decfile, 1 for a file that cannot be read or
written or for a device that is not there.  ``--device`` takes the
place of ``--backend`` (the port has one numerics, the JAX package's
numpy backend's) and of ``--workers`` (the card decodes every GOP of a
video at once).  Everything runs on the card unless ``--device cpu``
asks for the plain path.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from .models.image import ImageDecoder, ImageEncoder
from .models.video import VideoDecoder, VideoEncoder
from .utils import profiling
from .utils.config import ConfigReader
from .utils.device import resolve_device
from .utils.logger import Logger
from .utils.quant import QuantMatrix


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="imageencoder_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("config",
                    help="key=value settings file (reference schema)")
    ap.add_argument("--mode", choices=["encode", "decode", "both"],
                    default="both")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda = the kernels on the card (the default); "
                         "cpu = their plain versions")
    ap.add_argument("--no-huffman", action="store_true",
                    help="disable the whole-stream Huffman pass")
    ap.add_argument("--ref-mode", choices=["raw", "recon"], default="raw",
                    help="video motion reference: raw = shipped-binary "
                         "parity, recon = source-code semantics")
    ap.add_argument("--checkpoint-dir", default="",
                    help="video encode: persist per-GOP segments here and "
                         "resume after interruption (utils/checkpoint.py)")
    ap.add_argument("--block-size", type=int, default=4, choices=[4, 8],
                    help="image transform block size (reference supports 4; "
                         "8 requires --norm ortho)")
    ap.add_argument("--trace", action="store_true",
                    help="print a per-stage timing table for each encode/"
                         "decode (utils/profiling.py)")
    ap.add_argument("--norm", choices=["reference", "ortho"],
                    default="reference",
                    help="DCT scaling: reference = 4x4-only C() quirk "
                         "(bit parity), ortho = correct for any size")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    c = ConfigReader()
    if not c.read(args.config):
        print(f"Error reading file '{args.config}': {c.error}",
              file=sys.stderr)
        return 2
    mode = c.detect_mode()
    if mode == "invalid":
        print(f"Error in settings! {c.error}", file=sys.stderr)
        return 3
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    Logger.create(c.get("logfile"))
    try:
        return _run(c, mode, args)
    except OSError as e:
        # Reference behaviour: file-level errors abort with a message
        # (ImageBase.cpp:22-27 exits -1 at read time).
        print(str(e), file=sys.stderr)
        return 1
    finally:
        Logger.close()


@contextlib.contextmanager
def traced(on: bool, name: str, pixels: int | None = None):
    """--trace: collect the library's stage() marks and print the table
    after the operation; otherwise free."""
    if not on:
        yield
        return
    with profiling.tracing(name, pixels) as t:
        yield
    t.report()


def _elapsed(t0: float) -> None:
    Logger.write(f"Elapsed time: {1e3 * (time.perf_counter() - t0):.3f} ms")


def _run(c: ConfigReader, mode: str, args) -> int:
    use_huffman = not args.no_huffman
    common = dict(norm=args.norm, block_size=args.block_size,
                  device=args.device)
    if mode == "image":
        quant = QuantMatrix.from_file(c.get("quantfile"),
                                      size=args.block_size)
        w, h = int(c.get("width")), int(c.get("height"))
        if args.mode in ("encode", "both"):
            t0 = time.perf_counter()
            enc = ImageEncoder(c.get("rawfile"), c.get("encfile"), w, h,
                               bool(int(c.get("rle"))), quant,
                               use_huffman=use_huffman, **common)
            with traced(args.trace, "image encode", w * h):
                enc.process()
            enc.save_result()
            _elapsed(t0)
        if args.mode in ("decode", "both"):
            t0 = time.perf_counter()
            dec = ImageDecoder(c.get("encfile"), c.get("decfile"), **common)
            with traced(args.trace, "image decode", w * h):
                dec.process()
            dec.save_result()
            _elapsed(t0)
        return 0

    if mode == "video-encode":
        t0 = time.perf_counter()
        if args.mode != "decode":
            _encode_video(c, args, use_huffman, common)
            _elapsed(t0)
        if "decfile" in c.values and args.mode in ("decode", "both"):
            dec = VideoDecoder(c.get("encfile"), c.get("decfile"),
                               motioncomp=bool(int(
                                   c.get("motioncompensation", "1"))),
                               **common)
            with traced(args.trace, "video decode"):
                dec.process()
            dec.save_result()
        elif args.mode == "decode":
            # A decode-only run on an encoder-schema config that names no
            # decfile: returning 0 would read as success.
            print("--mode decode requested but the config has no decfile; "
                  "nothing was decoded", file=sys.stderr)
            return 4
        return 0

    # video-decode
    if args.mode == "encode":
        print("config is a video-decode job; nothing to encode",
              file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    dec = VideoDecoder(c.get("encfile"), c.get("decfile"),
                       motioncomp=bool(int(c.get("motioncompensation"))),
                       **common)
    with traced(args.trace, "video decode"):
        dec.process()
    dec.save_result()
    _elapsed(t0)
    return 0


def _encode_video(c: ConfigReader, args, use_huffman: bool,
                  common: dict) -> None:
    quant = QuantMatrix.from_file(c.get("quantfile"), size=args.block_size)
    w, h = int(c.get("width")), int(c.get("height"))
    rle, gop, merange = (bool(int(c.get("rle"))), int(c.get("gop")),
                         int(c.get("merange")))
    if not args.checkpoint_dir:
        enc = VideoEncoder(c.get("rawfile"), c.get("encfile"), w, h, rle,
                           quant, gop, merange, use_huffman=use_huffman,
                           ref_mode=args.ref_mode, **common)
        with traced(args.trace, "video encode"):
            enc.process()
        enc.save_result()
        return
    from .utils.checkpoint import encode_video_checkpointed

    with open(c.get("rawfile"), "rb") as f:
        data = f.read()
    Logger.write("[VideoEncoder] Processing video (checkpointed)...")
    with traced(args.trace, "video encode"):
        result = encode_video_checkpointed(
            data, w, h, quant, rle, gop, merange, args.checkpoint_dir,
            use_huffman=use_huffman, ref_mode=args.ref_mode, **common)
    with open(c.get("encfile"), "wb") as f:
        f.write(result)
    Logger.write(f"[VideoEncoder] Encoded size: {len(result)} bytes"
                 f" => Ratio: {len(result) / max(len(data), 1) * 100:.2f}%")


if __name__ == "__main__":
    raise SystemExit(main())
