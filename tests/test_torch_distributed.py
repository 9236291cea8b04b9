"""The port's process groups and GOP-distributed video encode
(imageencoder_tpu_torch.parallel.distributed) against the JAX package's
exact engine, encode_video(backend="numpy"), and its
parallel/distributed.py, at tolerance 0; the multi-process dry run; and
a world of one in this process, the layout the card runs over NCCL.

The two-process world is one module fixture: two processes, one torch
thread each, joined through a file store in a temporary directory
(parallel/dryrun.py::spawn_world, with its own deadline); each case is
its own test over its results."""

import numpy as np
import pytest

import torch
import torch.distributed as dist

import imageencoder_tpu
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.parallel import distributed as jax_dist
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.parallel import distributed, dryrun, sharding
from imageencoder_tpu_torch.parallel.mesh import make_mesh

W, H, N_FRAMES, GOP, MERANGE = 48, 32, 5, 2, 4  # 3 GOPs on 2 ranks
QM = QuantMatrix(np.array([[16, 11, 10, 16], [12, 12, 14, 19],
                           [14, 13, 16, 24], [14, 17, 22, 29]], np.uint32))
QP = port.quant_from_numpy(QM.matrix)


def video_bytes(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (H // 8, W // 8)), np.ones((8, 8)))
    frames = [np.clip(np.roll(base, (2 * f, 3 * f), (0, 1))
                      + rng.normal(0, 3, base.shape), 0, 255).astype(np.uint8)
              for f in range(N_FRAMES)]
    return b"".join(f.tobytes() + bytes([128]) * (W * H // 2)
                    for f in frames)


DATA = video_bytes(0)
CASES = [("raw", True), ("raw", False), ("recon", True)]


def host_video(ref_mode: str, use_huffman: bool) -> bytes:
    return jax_video.encode_video(DATA, W, H, QM, True, GOP, MERANGE,
                                  use_huffman=use_huffman, backend="numpy",
                                  ref_mode=ref_mode)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results of the GOP-distributed encode, a job a case."""
    jobs = [("gops", {"data": DATA, "width": W, "height": H, "quant": QP,
                      "use_rle": True, "gop": GOP, "merange": MERANGE,
                      "ref_mode": mode, "use_huffman": huff})
            for mode, huff in CASES]
    return dryrun.spawn_world(2, jobs, workdir=tmp_path_factory.mktemp("gop"),
                              timeout_s=240)


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[f"{m}-huffman={h}" for m, h in CASES])
def test_two_process_gop_encode_equals_host_engine(world, k):
    want = host_video(*CASES[k])
    for rank in world:
        stream, missing = rank[k]
        assert missing == []
        assert stream == want
    assert want == port.encode_video(DATA, W, H, QP, True, GOP, MERANGE,
                                     use_huffman=CASES[k][1],
                                     ref_mode=CASES[k][0], device="cpu")


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_encode_gops_equals_jax_segments(ref_mode):
    ids = [2, 0]
    got = distributed.encode_gops(DATA, W, H, QP, True, GOP, MERANGE, ids,
                                  device="cpu", ref_mode=ref_mode)
    want = jax_dist.encode_gops(DATA, W, H, QM, True, GOP, MERANGE, ids,
                                backend="numpy", ref_mode=ref_mode)
    assert got == want


@pytest.mark.parametrize("use_huffman", [True, False])
def test_assemble_equals_jax(use_huffman):
    segs = distributed.encode_gops(DATA, W, H, QP, True, GOP, MERANGE,
                                   [0, 1, 2], device="cpu")
    got = distributed.assemble(segs, N_FRAMES, W, H, QP, True, GOP, MERANGE,
                               use_huffman, device="cpu")
    assert got == jax_dist.assemble(segs, N_FRAMES, W, H, QM, True, GOP,
                                    MERANGE, use_huffman)
    assert got == host_video("raw", use_huffman)


@pytest.mark.parametrize("n_gops,n_hosts", [(7, 3), (3, 2), (1, 4), (8, 8)])
def test_gop_assignment_matches_jax(n_gops, n_hosts):
    got = [distributed.gop_assignment(n_gops, n_hosts, h)
           for h in range(n_hosts)]
    assert got == [jax_dist.gop_assignment(n_gops, n_hosts, h)
                   for h in range(n_hosts)]
    assert sorted(sum(got, [])) == list(range(n_gops))


def test_missing_gops_and_the_refusal_to_assemble():
    segs = distributed.encode_gops(DATA, W, H, QP, True, GOP, MERANGE,
                                   [0, 1, 2], device="cpu")
    broken = {0: segs[0], 2: (segs[2][0], 8 * len(segs[2][0]) + 1)}
    for bad in ({k: v for k, v in segs.items() if k != 1}, broken,
                {**segs, 1: (b"", 5)}, {**segs, 0: ("x", 1)}):
        assert distributed.missing_gops(bad, N_FRAMES, GOP) == (
            jax_dist.missing_gops(bad, N_FRAMES, GOP))
        assert distributed.missing_gops(bad, N_FRAMES, GOP)
        with pytest.raises(ValueError, match="missing or malformed"):
            distributed.assemble(bad, N_FRAMES, W, H, QP, True, GOP, MERANGE,
                                 device="cpu")
    assert distributed.missing_gops(segs, N_FRAMES, GOP) == []


def test_gather_segments_without_a_group_is_the_identity():
    segs = {1: (b"\x01\x02", 13)}
    assert distributed.gather_segments(segs, 3) == segs


def test_no_card_and_no_backend_raise():
    """Nothing falls back: a card asked for where there is none raises,
    and so does a device without a backend."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        distributed.initialize(device="cuda")
    with pytest.raises(RuntimeError):
        make_mesh(1, device="cuda")
    with pytest.raises(ValueError):
        distributed.initialize(device="meta")
    assert not dist.is_initialized()


def test_a_world_needs_its_coordinator():
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError):
        distributed.initialize("file:///nowhere", 2, 2, device="cpu")
    assert not dist.is_initialized()


def test_world_of_one_in_process():
    """The layout the card runs over NCCL, here over gloo in this
    process: a 1x1 mesh, the sharded encode (both stages) and decode equal
    to one device, and gather_segments the identity."""
    from tests.test_torch_image import smooth_image

    imgs = np.stack([smooth_image(64, 48, 30 + k) for k in range(2)])
    distributed.initialize(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already"):
            distributed.initialize(device="cpu")
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        want = [imageencoder_tpu.encode_image(im, QM, use_huffman=True,
                                              backend="numpy")
                for im in imgs]
        for entropy in (False, True):
            assert sharding.encode_sharded_image_batch(
                imgs, QP, mesh, device_entropy=entropy) == want
        got = sharding.decode_image_sharded(want[0], mesh)
        assert np.array_equal(got.numpy(), imageencoder_tpu.decode_image(
            want[0], backend="numpy"))
        segs = {0: (b"\x80", 1)}
        assert distributed.gather_segments(segs, 1) == segs
    finally:
        dist.destroy_process_group()


def test_sharded_inverse_half_equals_host_engine():
    """make_sharded_image_decode, the coefficient form of the decode's
    inverse half, in a world of one: equal to the exact engine's pixels."""
    from imageencoder_tpu.models.headers import read_image_header
    from imageencoder_tpu.models.image import extract_block_coeffs
    from imageencoder_tpu.ops.bitpack import BitReader
    from tests.test_torch_image import smooth_image

    img = smooth_image(32, 48, 3)
    data = imageencoder_tpu.encode_image(img, QM, use_huffman=False,
                                         backend="numpy")
    reader = BitReader(data, position=1)  # after the no-Huffman flag
    read_image_header(reader, 4)
    coeffs, _ = extract_block_coeffs(None, reader.position, 8 * 12, True, 4,
                                     packed=data)
    distributed.initialize(device="cpu")
    try:
        step = sharding.make_sharded_image_decode(make_mesh(device="cpu"),
                                                  32, 48)
        got = step(coeffs, QM.as_float())
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got.numpy(), imageencoder_tpu.decode_image(
        data, backend="numpy"))


def test_check_int32_bit_capacity():
    sharding.check_int32_bit_capacity(2**31 - 1)
    with pytest.raises(ValueError, match="int32"):
        sharding.check_int32_bit_capacity(2**31)


def test_dryrun_multichip_of_two():
    """The port's dryrun_multichip in a gloo world of 2: the sharded
    image encode (both stages), the decode, the GOP-distributed encode and
    the sharded video encode (raw and recon) and decode equal to one
    device."""
    got = dryrun.dryrun_multichip(2, timeout_s=240)
    assert got["world"] == 2 and got["mesh"] == (2, 1)
    assert len(got["checks"]) == 7


def test_spawn_world_kills_a_failed_world(tmp_path):
    """A rank that fails ends the world: the error comes back, with the
    rank's output, and no process is left."""
    with pytest.raises(RuntimeError, match="failed"):
        dryrun.spawn_world(2, [("decode", {"data": b""})],
                           workdir=tmp_path, timeout_s=120)
