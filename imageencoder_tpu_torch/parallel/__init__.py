"""Sharded and multi-process encode and decode over torch.distributed.

The counterpart of imageencoder_tpu/parallel/: the ("frame", "block") mesh
(mesh.py), the sharded image encode with its distributed Huffman stage and
the sharded image decode (sharding.py), the sharded video encode (a chunk
of frames and a stripe of rows a rank, the motion search on a haloed
stripe) and the GOP-sharded video decode (video_sharding.py), the
GOP-distributed video encode across processes (distributed.py), and a
multi-process dry run on the CPU (dryrun.py).
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
from .video_sharding import (assemble_sharded_video_packed,  # noqa: F401
                             decode_video_sharded,
                             encode_sharded_video_huffman,
                             encode_video_sharded,
                             make_sharded_video_decode,
                             make_sharded_video_packed,
                             make_sharded_video_step)
