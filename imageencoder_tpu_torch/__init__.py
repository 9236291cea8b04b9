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
    encode_image_batch   B same-shape images in one call: each kernel
                      launched once for the batch, at most two waits for the
                      device whatever B is (models/batch.py)
    encode_image_stream  a pipelined generator over an iterable of images:
                      ``depth`` images in flight, one wait per image
    decode_image_batch   many streams decoded with no wait between them,
                      the pixels left on the device
    encode_video_checkpointed  the video encode, resumable GOP by GOP
                      through a directory (utils/checkpoint.py)
    ImageEncoder, ImageDecoder, VideoEncoder, VideoDecoder
                      the CLI's file drivers
    QuantMatrix       quantization matrices (utils/quant.py)
    quant_from_numpy  a QuantMatrix from a numpy array, such as the matrix
                      of imageencoder_tpu's QuantMatrix

Both decodes parse the stream's dict and header on the host, upload the
stream once and run the rest on the card with nothing read back (videos:
the Huffman decode, one walk over the whole video's records, the vector
read, then frame k of every GOP at once, predicted by K7 from frame k - 1
and decoded onto it).

Serving: encode_image_batch(imgs, quant, device="cuda") takes u8
[B, H, W] (numpy or a tensor) and returns B streams; encode_image_stream
yields them one by one; decode_image_batch(streams) returns the pixels as
tensors on the card.  The command line, python -m imageencoder_tpu_torch
<settings.conf> [--device cuda|cpu], runs the reference's image and video
configs (cli.py) on the card, or with --device cpu on the plain path, as
the tests do; --checkpoint-dir makes a video encode resumable.
"""

from .models.batch import (decode_image_batch,  # noqa: F401
                           encode_image_batch, encode_image_stream)
from .models.image import (ImageDecoder, ImageEncoder,  # noqa: F401
                           decode_image, encode_image)
from .models.video import (VideoDecoder, VideoEncoder,  # noqa: F401
                           decode_frames, decode_video, encode_video)
from .utils.checkpoint import encode_video_checkpointed  # noqa: F401
from .utils.quant import QuantMatrix, quant_from_numpy  # noqa: F401

__version__ = "0.1.0"
