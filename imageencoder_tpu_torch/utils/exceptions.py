"""Typed codec errors.

The port's copy of what it uses from imageencoder_tpu/utils/exceptions.py:
the message-bearing base (Exceptions::Exception), the error a raw file of
the wrong size raises (an OSError, on which the CLI exits 1, as the
reference exits at read time, ImageBase.cpp:22-27) and the error a
malformed stream raises.  The reference decoder reads zeros past a
stream's end (BitStream.cpp:14-28) and decodes garbage; the codec fails
loudly on what no stream can hold (an empty stream, a Huffman dict no
code tree represents) instead.
"""

from __future__ import annotations


class CodecError(Exception):
    """Base (Exceptions::Exception)."""

    prefix = "Error"

    def __init__(self, msg: str = ""):
        super().__init__(f"{self.prefix}: {msg}" if msg else self.prefix)


class FileReadError(CodecError, OSError):
    prefix = "Cannot read file"


class StreamFormatError(CodecError, ValueError):
    """Malformed encoded stream."""

    prefix = "Malformed stream"
