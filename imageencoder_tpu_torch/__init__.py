"""imageencoder_tpu_torch: the codec's device image and video encode on
PyTorch and CUDA (an NVIDIA H100, sm_90a).

The port of imageencoder_tpu's JAX/Pallas device layer.  It imports torch
and never jax; the JAX package's host code (headers, Huffman dict, quant
matrices, the native engine) is shared, not copied.

Public API:
    encode_image   still-image encode on a torch device (reference format)
    encode_video   YUV420p video encode on a torch device (raw or recon
                   motion reference)
    QuantMatrix    quantization matrices (imageencoder_tpu.utils.quant)

Decode with imageencoder_tpu.decode_image(backend="fast") and
imageencoder_tpu.models.video.decode_video(backend="fast").
"""

from imageencoder_tpu.utils.quant import QuantMatrix  # noqa: F401

from .models.image import encode_image  # noqa: F401
from .models.video import encode_video  # noqa: F401

__version__ = "0.1.0"
