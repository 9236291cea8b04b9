"""Sharded and multi-process encode and decode over torch.distributed.

The counterpart of imageencoder_tpu/parallel/: the ("frame", "block") mesh
(mesh.py), the sharded image encode with its distributed Huffman stage and
the sharded image decode (sharding.py), the GOP-distributed video encode
across processes (distributed.py), and a multi-process dry run on the CPU
(dryrun.py).  The sharded video encode and decode (the JAX package's
video_sharding.py) are not ported yet.
"""

from .mesh import make_mesh  # noqa: F401
from .sharding import (assemble_packed_stream,  # noqa: F401
                       boundary_byte_histogram,
                       decode_image_sharded,
                       encode_sharded_huffman,
                       encode_sharded_image_batch,
                       make_sharded_encode_packed,
                       make_sharded_encode_step,
                       make_sharded_huffman_pack,
                       make_sharded_image_decode)
