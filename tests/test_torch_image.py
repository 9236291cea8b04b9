"""The port's main path, imageencoder_tpu_torch.encode_image, on the CPU:
byte-equal to the JAX package's host engine,
imageencoder_tpu.encode_image(backend="numpy"), and decodable by
imageencoder_tpu.decode_image(backend="fast"); plus the rule that the port
never imports jax."""

import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

import imageencoder_tpu
import imageencoder_tpu_torch
from imageencoder_tpu.ops.huffman import huffman_encode
from imageencoder_tpu.utils.quant import QuantMatrix
from imageencoder_tpu_torch import quant_from_numpy
from imageencoder_tpu_torch.ops import huffman
from imageencoder_tpu_torch.ops.device_pack import header_to_words
from imageencoder_tpu_torch.ops.pipeline import make_encode_packed
from imageencoder_tpu_torch.utils.device import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
JPEG4 = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]


def smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth field plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = (128 + 60 * np.sin(x / 9.0) * np.cos(y / 7.0)
         + rng.normal(0, 6, (h, w)))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def quant_for(b: int) -> QuantMatrix:
    if b == 4:
        return QuantMatrix(np.array(JPEG4, np.uint32))
    i, j = np.indices((b, b))
    return QuantMatrix((1 + 2 * (i + j)).astype(np.uint32))


CASES = [  # h, w, use_rle, use_huffman, block size, norm
    (64, 96, True, True, 4, "reference"),
    (64, 96, False, True, 4, "reference"),
    (64, 96, True, False, 4, "reference"),
    (64, 96, False, False, 4, "reference"),
    (20, 24, True, True, 4, "reference"),
    (64, 64, True, True, 8, "ortho"),
    (64, 64, True, False, 8, "ortho"),
]


@pytest.mark.parametrize("h,w,use_rle,use_huffman,b,norm", CASES)
def test_encode_image_equals_host_engine(h, w, use_rle, use_huffman, b,
                                         norm):
    img = smooth_image(h, w, h + w)
    quant = quant_for(b)
    got = imageencoder_tpu_torch.encode_image(
        img, quant_from_numpy(quant.matrix), use_rle=use_rle,
        use_huffman=use_huffman, norm=norm, block_size=b, device="cpu")
    want = imageencoder_tpu.encode_image(
        img, quant, use_rle=use_rle, use_huffman=use_huffman, norm=norm,
        backend="numpy", block_size=b)
    assert got == want
    if use_huffman and h * w >= 4096:
        assert got[0] & 0x80  # the dict paid for itself: Huffman, no copy
    dec = imageencoder_tpu.decode_image(got, norm=norm, backend="fast",
                                        block_size=b)
    assert dec.shape == img.shape
    np.testing.assert_array_equal(
        dec, imageencoder_tpu.decode_image(want, norm=norm, backend="fast",
                                           block_size=b))


def test_incompressible_image_takes_the_fallback():
    img = np.random.default_rng(9).integers(0, 256, (64, 64), np.uint8)
    quant = QuantMatrix(np.ones((4, 4), np.uint32))
    got = imageencoder_tpu_torch.encode_image(
        img, quant_from_numpy(quant.matrix), use_huffman=True, device="cpu")
    want = imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                         backend="numpy")
    assert got == want
    assert not got[0] & 0x80  # '0' flag bit then the raw inner stream
    np.testing.assert_array_equal(
        imageencoder_tpu.decode_image(got, backend="fast"),
        imageencoder_tpu.decode_image(want, backend="fast"))


def test_encode_image_accepts_a_tensor():
    img = smooth_image(32, 32, 3)
    quant = quant_for(4)
    assert (imageencoder_tpu_torch.encode_image(
        torch.from_numpy(img), quant_from_numpy(quant.matrix),
        use_huffman=True, device="cpu")
            == imageencoder_tpu.encode_image(img, quant, use_huffman=True))


def test_encode_packed_ors_the_header_in():
    img = torch.from_numpy(smooth_image(16, 32, 4))
    header = np.zeros(64 * 4, np.uint8)
    header[:3] = [0xAB, 0xCD, 0xE0]
    hw = torch.from_numpy(header_to_words(header[:3].tobytes())
                          .view(np.int32))
    words, total = make_encode_packed()(img, quant_for(4).as_float(), 19, hw)
    bare, bare_total = make_encode_packed()(img, quant_for(4).as_float(), 19,
                                            torch.zeros(64, dtype=torch.int32))
    assert int(total) == int(bare_total)
    assert torch.equal(words[1:], bare[1:])
    assert words[0].item() == (bare[0].item() | int(hw[0].item()))


def test_huffman_encode_device_matches_host_huffman():
    rng = np.random.default_rng(6)
    data = (rng.integers(0, 40, 5000) * 3).astype(np.uint8).tobytes()
    padded = np.zeros(2048 * 4, np.uint8)
    padded[:len(data)] = np.frombuffer(data, np.uint8)
    words = torch.from_numpy(padded.view(">u4").astype(np.uint32)
                             .view(np.int32))
    assert huffman.huffman_encode_device(words, 8 * len(data)) == \
        huffman_encode(data)


def test_cuda_device_is_never_silently_replaced():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import imageencoder_tpu_torch as port
        from imageencoder_tpu import encode_image
        img = np.random.default_rng(0).integers(0, 256, (16, 24), np.uint8)
        q = port.QuantMatrix(np.full((4, 4), 8, np.uint32))
        got = port.encode_image(img, q, use_huffman=True, device="cpu")
        assert got == encode_image(img, q, use_huffman=True)
        assert sys.modules["jax"] is None
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    files = sorted((REPO / "imageencoder_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        assert not pat.search(path.read_text()), path


def test_chip_smoke_imports_only_the_port():
    """The smoke and every module of the port stand alone: no import of
    the JAX package's modules, under any name, only of
    imageencoder_tpu_torch."""
    pat = re.compile(r"^\s*(import|from)\s+imageencoder_tpu(?!_torch)\b",
                     re.M)
    text = (REPO / "chip_smoke.py").read_text()
    assert "imageencoder_tpu_torch" in text
    files = sorted((REPO / "imageencoder_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    for path in [REPO / "chip_smoke.py", *files]:
        text = path.read_text()
        assert not pat.search(text), path
        assert '"imageencoder_tpu.' not in text, path
        assert "'imageencoder_tpu." not in text, path
        assert '"imageencoder_tpu"' not in text.replace(
            'sys.modules["imageencoder_tpu"] = None', ""), path


def test_kernel_build_raises_or_builds():
    """The kernel library builds from csrc/ where nvcc exists, and raises
    where it does not: nothing falls back."""
    from imageencoder_tpu_torch.kernels import build

    assert {p.name for p in build.sources()} >= {
        "encode.cu", "pack.cu", "histogram.cu", "bits.cuh"}
    try:
        nvcc = build.nvcc_path()
    except RuntimeError:
        nvcc = None
    if nvcc is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build()
    else:
        assert build.build().exists()
