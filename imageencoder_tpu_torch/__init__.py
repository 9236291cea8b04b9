"""imageencoder_tpu_torch: the codec's device image and video encode and
decode on PyTorch and CUDA (an NVIDIA H100, sm_90a).

The port of imageencoder_tpu's JAX/Pallas device layer.  It imports torch
and never jax, and nothing of imageencoder_tpu: it keeps its own copy of
the host code it needs (headers, bit packing, quant matrices, DCT tables,
the Huffman dict), so it runs where the JAX package is absent.

Public API:
    encode_image      still-image encode on a torch device (reference
                      format)
    encode_video      YUV420p video encode on a torch device (raw or recon
                      motion reference)
    decode_image      still-image decode on a torch device, pixel for pixel
                      as the JAX package's exact engine
    decode_video      video decode on a torch device to YUV420p bytes,
                      frame for frame as the JAX package's exact engine
    decode_frames     the same video decode's Y planes, left on the device
    QuantMatrix       quantization matrices (utils/quant.py)
    quant_from_numpy  a QuantMatrix from a numpy array, such as the matrix
                      of imageencoder_tpu's QuantMatrix

Both decodes parse the stream's dict and header on the host, upload the
stream once and run the rest on the card with nothing read back (videos:
the Huffman decode, one walk over the whole video's records, the vector
read, then frame k of every GOP at once, predicted by K7 from frame k - 1
and decoded onto it).
"""

from .models.image import decode_image, encode_image  # noqa: F401
from .models.video import (decode_frames, decode_video,  # noqa: F401
                           encode_video)
from .utils.quant import QuantMatrix, quant_from_numpy  # noqa: F401

__version__ = "0.1.0"
