"""The decode's staging buffer on the CPU (models/image.py::parse_stream):
the layout and the shared fill, held against a zeroed buffer filled with
the same parts.

The fill writes into a destination it does not clear first (on a card a
pinned block that may hold an earlier stream), so it zeroes every pad
itself; here its destination starts full of garbage, and image and video
streams, with and without Huffman, must stage byte for byte as into a
zeroed buffer.  Parts of odd lengths leave a pad after every part.
"""

import numpy as np
import pytest

import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.models import image, video
from imageencoder_tpu_torch.ops import huffman

from test_torch_image import smooth_image  # tests/ is on the path

QUANT = port.quant_from_numpy(np.array([[16, 11, 10, 16], [12, 12, 14, 19],
                                        [14, 13, 16, 24], [14, 17, 22, 29]]))


def zeroed_staging(parts) -> tuple[dict, np.ndarray]:
    """The staging as a zeroed buffer with each part copied in: (layout,
    buffer)."""
    layout, pos = {}, 0
    for name, arr in parts:
        if arr is None:
            continue
        layout[name] = (pos, arr.nbytes)
        pos += -(-arr.nbytes // 16) * 16 + (16 if name == "stream" else 0)
    buf = np.zeros(pos, np.uint8)
    for name, arr in parts:
        if arr is not None:
            off, n = layout[name]
            buf[off:off + n] = np.ascontiguousarray(arr).reshape(-1).view(
                np.uint8)
    return layout, buf


def stream_of(kind: str, use_huffman: bool) -> bytes:
    if kind == "image":
        return port.encode_image(smooth_image(96, 128, 1), QUANT, True,
                                 use_huffman=use_huffman, device="cpu")
    w, h, n = 48, 32, 6
    frames = [np.roll(smooth_image(h, w, 2), (f, 2 * f), (0, 1))
              for f in range(n)]
    data = b"".join(f.tobytes() + bytes(w * h // 2) for f in frames)
    return port.encode_video(data, w, h, QUANT, True, 3, 8,
                             use_huffman=use_huffman, device="cpu")


def parts_of(data: bytes, plan: dict):
    """The parts parse_stream stages for ``data``, built as it builds
    them."""
    table = None
    if plan["huffman"]:
        entries, _ = huffman.parse_dict_bytes(data)
        table = huffman.decode_table(entries)[0]
    return [("nbytes", np.array([len(data), 0], np.int64)),
            ("quant", plan["quant"].as_float().reshape(-1)),
            ("table", table),
            ("stream", np.frombuffer(data, np.uint8))]


@pytest.mark.parametrize("use_huffman", [True, False])
@pytest.mark.parametrize("kind", ["image", "video"])
def test_staging_equals_a_zeroed_buffer(kind, use_huffman):
    data = stream_of(kind, use_huffman)
    plan = (video.plan_video(data) if kind == "video"
            else image.parse_stream(data))
    assert plan["huffman"] == use_huffman
    parts = parts_of(data, plan)
    layout, want = zeroed_staging(parts)
    assert plan["parts"] == layout
    assert ("table" in layout) == use_huffman
    # On the CPU the plan stays a numpy array.
    assert isinstance(plan["staging"], np.ndarray)
    assert plan["staging"].dtype == np.uint8
    np.testing.assert_array_equal(plan["staging"], want)
    got_layout, size = image.staging_layout(parts)
    assert (got_layout, size) == (layout, want.size)
    for fill in (0xFF, 0x5A):
        dest = np.full(size, fill, np.uint8)
        assert image.fill_staging(dest, parts, layout) is dest
        np.testing.assert_array_equal(dest, want)


@pytest.mark.parametrize("sizes", [(3, 5, 7, 1), (1, 17, 0, 31),
                                   (9, 1, 33, 16), (2, 16, None, 15)])
def test_fill_zeroes_every_pad(sizes):
    """Parts of odd lengths, so that a pad follows each: a destination of
    random garbage comes out as the zeroed buffer, each pad zero."""
    rng = np.random.default_rng(sum(s or 0 for s in sizes))
    names = ("nbytes", "quant", "table", "stream")
    parts = [(name, None if n is None else
              rng.integers(1, 256, n).astype(np.uint8))
             for name, n in zip(names, sizes)]
    layout, want = zeroed_staging(parts)
    dest = rng.integers(1, 256, want.size).astype(np.uint8)
    image.fill_staging(dest, parts, layout)
    np.testing.assert_array_equal(dest, want)
    data = np.zeros(want.size, bool)
    for off, n in layout.values():
        data[off:off + n] = True
    assert (~data).sum() >= 16 and not dest[~data].any()
