"""The port's sharded video encode and decode
(imageencoder_tpu_torch/parallel/video_sharding.py) in gloo worlds of four
CPU processes, at tolerance 0:

  * the streams of encode_video_sharded, raw and recon, Huffman on and
    off, and of the distributed Huffman stage, equal to the JAX package's
    encode_video(backend="numpy"): in the (1, 4) world each stripe is
    exactly merange = 16 rows tall, and the gop-3 video puts a P-frame at
    the start of a chunk in the (2, 2) and (4, 1) worlds; recon at gops
    1 to 8, a short last GOP and one GOP of the whole chunk among them;
  * the recon encode stepped by GOP: a rank's stripe searches, recon
    steps and halo shifts counted (one search and one recon step a step,
    two shifts a step where there is more than one stripe), in the gloo
    worlds and in a world of one in this process;
  * the frames of decode_video_sharded equal to decode_video(backend=
    "numpy"), with motion compensation on and off, and with GOP counts
    that do not fill the mesh;
  * the layout of make_sharded_video_step and make_sharded_video_packed
    (the fields, the block bits, the histograms and each segment's words
    on their defined span) equal to the JAX functions on the conftest's
    virtual mesh, make_mesh(4, frame_axis), on inputs where the JAX
    package's f32 transform meets no rounding tie;
  * the refusals: zero frames, stripes shorter than merange or of no
    whole macroblocks, recon chunks that do not open a GOP: the port
    raises ValueError where the JAX package raises (with its message
    where it asserts), but for one chunk of a length no multiple of the
    GOP, which the port encodes;
  * decode_image_sharded of images of zero blocks;
  * assemble_sharded_video of the step's fields (on the CPU when asked,
    on a card by default), and a mesh over gloo on cards only where the
    ranks outnumber the cards.

Each world is one module fixture: every case's job runs once in one
spawn_world of four processes (parallel/dryrun.py), and each case is its
own test over the results."""

import numpy as np
import pytest

import jax
import torch
import torch.distributed as dist

import imageencoder_tpu
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.models.video import mvec_bits
from imageencoder_tpu.parallel import make_mesh as jax_make_mesh
from imageencoder_tpu.parallel import video_sharding as jax_vs
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.models.headers import VideoParams
from imageencoder_tpu_torch.models.video import video_header
from imageencoder_tpu_torch.parallel import dryrun
from imageencoder_tpu_torch.parallel import mesh as port_mesh
from imageencoder_tpu_torch.parallel import video_sharding as port_vs

WORLDS = [(2, 2), (4, 1), (1, 4)]  # (frame, block) of a world of 4
W, H, MERANGE = 48, 64, 16
QM = QuantMatrix(np.full((4, 4), 13, np.uint32))
QP = port.quant_from_numpy(QM.matrix)


def moving_frames(n: int, h: int, w: int, seed: int, sigma: float = 3.0,
                  blk: int = 8) -> np.ndarray:
    """blk x blk random blocks moving (2, 3) px a frame plus noise, u8."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // blk + 4, w // blk + 4))
    big = np.kron(base, np.ones((blk, blk)))
    out = [big[2 * f % 32:2 * f % 32 + h, 3 * f % 32:3 * f % 32 + w]
           + rng.normal(0, sigma, (h, w)) for f in range(n)]
    return np.clip(out, 0, 255).astype(np.uint8)


def yuv(frames: np.ndarray) -> bytes:
    h, w = frames.shape[1:]
    return b"".join(f.tobytes() + bytes([128]) * (h * w // 2)
                    for f in frames)


VIDEO = moving_frames(16, H, W, 7)     # gop 4: chunks of 4, 16 or 4 frames
GOP3 = moving_frames(8, H, W, 8)       # gop 3: a P-frame opens a chunk
SHORT = moving_frames(5, H, W, 9)      # 2 GOPs of 4: the mesh not filled
RAGGED = moving_frames(11, H, W, 10)   # gop 3: a short last GOP
CASES = {"raw": (VIDEO, 4, "raw"), "recon": (VIDEO, 4, "recon"),
         "gop3": (GOP3, 3, "raw"),
         # recon in one chunk of 8 frames at gop 3 ((1, 4) only): the
         # chunk opens the video's first GOP, its last GOP is short
         "recon_gop3": (GOP3, 3, "recon"),
         "recon_gop2": (VIDEO, 2, "recon"),
         # every frame an I-frame: no GOP step, no halo exchange
         "recon_gop1": (VIDEO, 1, "recon"),
         # one chunk ((1, 4) only) in GOPs of 5 and 3 frames: the steps
         # k = 3, 4 run over one GOP, k = 1, 2 over two
         "recon_gop5": (GOP3, 5, "recon"),
         # one chunk ((1, 4) only) of one GOP: every step over one frame
         "recon_gop8": (GOP3, 8, "recon")}
RECON_CASES = [k for k, (_, _, mode) in CASES.items() if mode == "recon"]
# The calls a sharded recon encode makes a GOP step (job "calls").
COUNTED = ("parallel.video_sharding.shift",
           "ops.cuda_motion.search_predict_stripe",
           "ops.cuda_encode.recon_step")
# The layout cases: a video on which the JAX package's sharded step, whose
# transform is f32, meets no rounding tie (a seed searched for; its f32
# transform differs from the exact one in about 1.6% of the blocks of the
# videos above), under quant 16.
LAYOUT = moving_frames(8, H, W, 9, sigma=1.0, blk=16)
QL = QuantMatrix(np.full((4, 4), 16, np.uint32))
LAYOUT_CASES = {"raw": (LAYOUT, 4, "raw"), "recon": (LAYOUT, 4, "recon")}


def host_encode(frames, gop, ref_mode, use_huffman=True, quant=QM) -> bytes:
    h, w = frames.shape[1:]
    return bytes(jax_video.encode_video(
        yuv(frames), w, h, quant, True, gop, MERANGE,
        use_huffman=use_huffman, ref_mode=ref_mode, backend="numpy"))


DECODES = {"raw": host_encode(VIDEO, 4, "raw"),
           "recon": host_encode(VIDEO, 4, "recon"),
           "short": host_encode(SHORT, 4, "raw", use_huffman=False),
           "ragged": host_encode(RAGGED, 3, "raw")}
ZERO = {(shape, huff): imageencoder_tpu.encode_image(
    np.zeros(shape, np.uint8), QM, use_huffman=huff, backend="numpy")
    for shape in ((0, 16), (16, 0), (0, 0)) for huff in (True, False)}


def decode_step_inputs(data: bytes) -> dict:
    """The coefficients [G, gop, N, 4, 4] and vectors [G, gop, Nmb, 2] of a
    stream, as the JAX package's decode_video_sharded extracts them on the
    host (its GOPs padded to the mesh's 4 ranks)."""
    from imageencoder_tpu.models.video import parse_video_stream
    from imageencoder_tpu.ops.zigzag import zigzag_order
    from imageencoder_tpu.runtime.native import extract_coeffs_native

    payload, quant, _, params, w, h, parsed = parse_video_stream(data, 4)
    gop, n = params.gop, params.frame_count
    g = -(-(-(-n // gop)) // 4) * 4
    coeffs = np.zeros((g, gop, (w // 4) * (h // 4), 4, 4), np.int32)
    mvec = np.zeros((g, gop, (w // 16) * (h // 16), 2), np.int32)
    for fi, (mv, _, (offs, dbits, counts)) in enumerate(parsed):
        coeffs[fi // gop, fi % gop] = extract_coeffs_native(
            payload, offs, dbits, counts, zigzag_order(4), 4).reshape(-1, 4,
                                                                      4)
        if mv is not None:
            mvec[fi // gop, fi % gop] = mv
    return {"coeffs": coeffs, "mvec": mvec, "quant": quant.as_float(),
            "h": h, "w": w, "gop": gop}


def start_bit(frames, gop) -> int:
    f, h, w = frames.shape
    return video_header(QP, True, w, h, VideoParams(f, gop, MERANGE),
                        True).position


def _refusals(fa: int) -> dict:
    """Each refused input: (job name, its kwargs)."""
    sa = 4 // fa
    base = {"quant": QP, "gop": 4, "merange": MERANGE}
    return {
        "zero frames": ("video_encode", dict(
            base, frames=np.zeros((0, H, W), np.uint8))),
        "short stripes": ("video_encode", dict(
            base, frames=moving_frames(4, 8 * sa, W, 1))),
        "no whole macroblocks": ("video_encode", dict(
            base, frames=moving_frames(4, 24 * sa, W, 1), merange=8)),
        "recon unaligned": ("video_encode", dict(
            base, frames=moving_frames(4 * fa, H, W, 1), gop=8,
            ref_mode="recon")),
    }


REFUSALS = {fa: _refusals(fa) for fa, _ in WORLDS}
DECODE_STEP = decode_step_inputs(DECODES["recon"])


def jobs(fa: int) -> list:
    out = [("mesh", {})]
    for frames, gop, mode in CASES.values():
        if mode == "recon" and not has_recon(fa, frames, gop):
            out.append(("raises", {"job": "video_encode", "frames": frames,
                                   "quant": QP, "gop": gop,
                                   "merange": MERANGE, "ref_mode": mode}))
            continue
        for huff in (True, False):
            out.append(("video_encode", {
                "frames": frames, "quant": QP, "gop": gop,
                "merange": MERANGE, "use_huffman": huff, "ref_mode": mode}))
        out.append(("video_huffman", {"frames": frames, "quant": QP,
                                      "gop": gop, "merange": MERANGE,
                                      "ref_mode": mode}))
        if mode == "recon":
            out.append(("calls", {"job": "video_encode", "names": COUNTED,
                                  "frames": frames, "quant": QP, "gop": gop,
                                  "merange": MERANGE, "ref_mode": mode}))
    for frames, gop, mode in LAYOUT_CASES.values():
        if mode == "recon" and not has_recon(fa, frames, gop):
            out.append(("raises", {"job": "video_packed", "frames": frames,
                                   "quant": QL.as_float(), "gop": gop,
                                   "merange": MERANGE, "start_bit": 0,
                                   "ref_mode": mode}))
            continue
        out.append(("video_packed", {
            "frames": frames, "quant": QL.as_float(), "gop": gop,
            "merange": MERANGE, "start_bit": start_bit(frames, gop),
            "ref_mode": mode}))
    out.append(("video_step", {"frames": LAYOUT, "quant": QL.as_float(),
                               "gop": 4, "merange": MERANGE}))
    # Calls of at most 4 frames a rank: the video in GOP-aligned chunks.
    out.append(("video_encode", {"frames": VIDEO, "quant": QP, "gop": 4,
                                 "merange": MERANGE, "frames_per_call": 4}))
    for data in DECODES.values():
        for mc in (True, False):
            out.append(("video_decode", {"data": data, "motioncomp": mc}))
    for mc in (True, False):
        out.append(("video_decode_step", dict(DECODE_STEP, motioncomp=mc)))
    for data in ZERO.values():
        out.append(("decode", {"data": data}))
    for job, kw in REFUSALS[fa].values():
        out.append(("raises", dict(kw, job=job)))
    return [(name, dict(kw, frame_axis=fa)) for name, kw in out]


@pytest.fixture(scope="module", params=WORLDS,
                ids=[f"{f}x{b}" for f, b in WORLDS])
def world(request, tmp_path_factory):
    fa, _ = request.param
    work = tmp_path_factory.mktemp(f"video{fa}")
    return fa, dryrun.spawn_world(4, jobs(fa), workdir=work, timeout_s=240)


def result(world, name: str, **match):
    """Rank 0's result of the first job of ``name`` whose kwargs match
    (arrays by identity)."""
    fa, ranks = world
    for k, (job, kw) in enumerate(jobs(fa)):
        if job == name and all(
                kw.get(a) is v if isinstance(v, np.ndarray)
                else kw.get(a) == v for a, v in match.items()):
            return ranks[0][k]
    raise KeyError(name, match)


def has_recon(fa: int, frames=VIDEO, gop: int = 4) -> bool:
    """Whether every chunk of the frames opens a GOP (recon mode)."""
    return fa == 1 or (len(frames) // fa) % gop == 0


def assert_recon_refused(world, frames, gop):
    """The recon encode of frames whose chunks do not all open a GOP is
    refused with the JAX package's message."""
    fa, _ = world
    got = result(world, "raises", frames=frames, ref_mode="recon", gop=gop)
    assert got == ("ValueError", f"recon mode needs GOP-aligned frame "
                   f"chunks: {len(frames) // fa} frames/chunk vs gop {gop}")


def test_every_rank_returns_the_global_result(world):
    fa, ranks = world
    for r in range(1, 4):
        for k, (a, b) in enumerate(zip(ranks[0][1:], ranks[r][1:])):
            assert dryrun._same(a, b), (r, jobs(fa)[k + 1][0])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("use_huffman", [True, False])
def test_encode_equals_host_engine(world, case, use_huffman):
    frames, gop, mode = CASES[case]
    if mode == "recon" and not has_recon(world[0], frames, gop):
        assert_recon_refused(world, frames, gop)
        return
    got = result(world, "video_encode", frames=frames, ref_mode=mode,
                 use_huffman=use_huffman, gop=gop)
    assert got == host_encode(frames, gop, mode, use_huffman)
    assert bool(got[0] & 0x80) == use_huffman


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_huffman_equals_host_engine(world, case):
    frames, gop, mode = CASES[case]
    if mode == "recon" and not has_recon(world[0], frames, gop):
        assert_recon_refused(world, frames, gop)
        return
    got = result(world, "video_huffman", frames=frames, ref_mode=mode,
                 gop=gop)
    assert got == host_encode(frames, gop, mode)


@pytest.mark.parametrize("case", RECON_CASES)
def test_recon_steps_by_gop(world, case):
    """A rank's recon encode makes one stripe search and one recon step a
    GOP step, min(gop, f_loc) - 1 of them, and exchanges the carry's
    halo in two shifts a step where the "block" axis has more than one
    stripe: twice the steps, not twice the P-frames."""
    fa, _ = world
    frames, gop, _ = CASES[case]
    if not has_recon(fa, frames, gop):
        assert_recon_refused(world, frames, gop)
        return
    stream, calls = result(world, "calls", frames=frames, gop=gop)
    assert stream == host_encode(frames, gop, "recon")
    steps = min(gop, len(frames) // fa) - 1
    shift, search, recon = COUNTED
    assert calls == {search: steps, recon: steps,
                     shift: 2 * steps if 4 // fa > 1 else 0}


@pytest.mark.parametrize("gop", [1, 2, 4, 5, 16, 20])
def test_world_of_one_steps_by_gop(monkeypatch, gop):
    """In a world of one in this process, one stripe of the whole frame
    and no halo: the recon encode makes one stripe search and one recon
    step a GOP step, min(gop, F) - 1 of each, and no shift; its stream is
    the host engine's (gop 5: a short last GOP; 16 and 20: one GOP)."""
    from imageencoder_tpu_torch.ops import cuda_encode, cuda_motion
    from imageencoder_tpu_torch.parallel import distributed

    calls = {"search": 0, "recon": 0, "shift": 0}

    def counted(key, real):
        def call(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(cuda_motion, "search_predict_stripe", counted(
        "search", cuda_motion.search_predict_stripe))
    monkeypatch.setattr(cuda_encode, "recon_step", counted(
        "recon", cuda_encode.recon_step))
    monkeypatch.setattr(port_vs, "shift", counted("shift", port_vs.shift))
    distributed.initialize(device="cpu")
    try:
        got = port_vs.encode_video_sharded(
            VIDEO, QP, port_mesh.make_mesh(device="cpu"), True, gop,
            MERANGE, ref_mode="recon")
    finally:
        dist.destroy_process_group()
    steps = min(gop, len(VIDEO)) - 1
    assert calls == {"search": steps, "recon": steps, "shift": 0}
    assert got == host_encode(VIDEO, gop, "recon")


def test_calls_of_few_frames_give_the_same_stream(world):
    got = result(world, "video_encode", frames=VIDEO, frames_per_call=4)
    assert got == host_encode(VIDEO, 4, "raw")


@pytest.mark.parametrize("key", list(DECODES))
@pytest.mark.parametrize("motioncomp", [True, False])
def test_decode_equals_host_engine(world, key, motioncomp):
    data = DECODES[key]
    stream, (n, gop, merange), size = result(world, "video_decode",
                                             data=data, motioncomp=motioncomp)
    want, params, want_size = jax_video.decode_video(
        data, motioncomp=motioncomp, backend="numpy")
    assert stream == want and size == want_size
    assert (n, gop, merange) == (params.frame_count, params.gop,
                                 params.merange)


@pytest.mark.parametrize("motioncomp", [True, False])
def test_decode_step_equals_host_engine(world, motioncomp):
    """make_sharded_video_decode from the stream's coefficients and
    vectors: the frames of decode_video(backend="numpy")."""
    got = result(world, "video_decode_step", motioncomp=motioncomp)
    yuv420, params, (w, h) = jax_video.decode_video(
        DECODES["recon"], motioncomp=motioncomp, backend="numpy")
    n = params.frame_count
    want = np.frombuffer(yuv420, np.uint8).reshape(n, -1)[:, :h * w]
    assert np.array_equal(got.reshape(-1, h * w)[:n], want)


@pytest.mark.parametrize("key", list(ZERO), ids=str)
def test_decode_image_sharded_of_zero_blocks(world, key):
    got = result(world, "decode", data=ZERO[key])
    want = imageencoder_tpu.decode_image(ZERO[key], backend="numpy")
    assert got.shape == want.shape == key[0] and got.dtype == want.dtype


@pytest.mark.parametrize("what", ["zero frames", "short stripes",
                                  "no whole macroblocks", "recon unaligned"])
def test_refusals_match_the_jax_package(world, what):
    """The port raises ValueError (with the JAX package's message where it
    asserts) on the inputs the JAX package's sharded encode refuses."""
    fa, _ = world
    _, kw = REFUSALS[fa][what]
    got = result(world, "raises", frames=kw["frames"])
    if what == "recon unaligned" and fa == 1:
        # One chunk of 4 frames opens the video's only GOP: the port
        # encodes it (the JAX package's assert, f_loc % gop, refuses it).
        assert got is None
    else:
        assert got is not None and got[0] == "ValueError", got
    mesh = jax_make_mesh(4, frame_axis=fa)
    with pytest.raises(Exception) as err:
        jax_vs.encode_video_sharded(kw["frames"], QM, mesh, True, kw["gop"],
                                    kw["merange"],
                                    ref_mode=kw.get("ref_mode", "raw"))
    if isinstance(err.value, AssertionError) and got is not None:
        assert got[1] == str(err.value)


@pytest.mark.parametrize("use_huffman", [True, False])
def test_assemble_sharded_video_equals_host_engine(world, use_huffman):
    """The stream assembled from make_sharded_video_step's fields, with
    Huffman on the CPU where the caller asks for it."""
    mvals, bvals, bnbits, _ = result(world, "video_step", frames=LAYOUT)
    got = port_vs.assemble_sharded_video(
        mvals, bnbits, bvals, W, H, port.quant_from_numpy(QL.matrix), True,
        4, MERANGE, use_huffman, device="cpu")
    assert got == host_encode(LAYOUT, 4, "raw", use_huffman, QL)


def test_assemble_sharded_video_runs_on_the_card(world):
    """Numpy fields and no device: the Huffman stage runs on a card, or
    raises where there is none; it never falls back to the CPU."""
    mvals, bvals, bnbits, _ = result(world, "video_step", frames=LAYOUT)

    def assemble():
        return port_vs.assemble_sharded_video(
            mvals, bnbits, bvals, W, H, port.quant_from_numpy(QL.matrix),
            True, 4, MERANGE)

    if torch.cuda.is_available():
        assert assemble() == host_encode(LAYOUT, 4, "raw", True, QL)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            assemble()


@pytest.mark.parametrize("world_size, cards", [(1, 1), (2, 2), (2, 4)])
def test_gloo_mesh_on_cards_needs_more_ranks_than_cards(monkeypatch,
                                                        world_size, cards):
    """A gloo group serves a card's mesh only for processes that share a
    card; with a card for every rank the mesh needs NCCL and raises."""
    monkeypatch.setattr(port_mesh, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: world_size)
    with pytest.raises(RuntimeError, match="runs gloo; a cuda mesh needs"):
        port_mesh.make_mesh(device="cuda")


# ---- the layout against the JAX functions on the virtual mesh ----

_JAX = {}


def jax_packed(fa: int, case: str):
    frames, gop, mode = LAYOUT_CASES[case]
    key = (fa, case)
    if key not in _JAX:
        step = jax_vs.make_sharded_video_packed(
            jax_make_mesh(4, frame_axis=fa), gop, MERANGE, mvec_bits(MERANGE),
            ref_mode=mode)
        _JAX[key] = [np.asarray(x) for x in jax.block_until_ready(step(
            frames, QL.as_float(np.float32),
            np.int32(start_bit(frames, gop))))]
    return _JAX[key]


@pytest.mark.parametrize("fa", [f for f, _ in WORLDS])
def test_layout_inputs_have_no_f32_ties(fa):
    """The JAX package's sharded encode of the layout video (its f32
    transform) equals its exact engine's stream, so its sharded steps are
    a layout reference at tolerance 0 there."""
    mesh = jax_make_mesh(4, frame_axis=fa)
    for frames, gop, mode in LAYOUT_CASES.values():
        if mode == "recon" and not has_recon(fa, frames, gop):
            continue
        assert jax_vs.encode_video_sharded(
            frames, QL, mesh, True, gop, MERANGE, use_huffman=False,
            ref_mode=mode) == host_encode(frames, gop, mode, False, QL)


@pytest.mark.parametrize("case", ["raw", "recon"])
def test_packed_layout_matches_jax(world, case):
    """The block bits, the histograms of the segments' whole bytes, and
    each segment's words on its defined span (word 0 the stream's word
    base >> 5, up to the segment's last word), in both kinds."""
    fa, _ = world
    frames, gop, mode = LAYOUT_CASES[case]
    if mode == "recon" and not has_recon(fa, frames, gop):
        assert_recon_refused(world, frames, gop)
        return
    mvw, blw, bits, hist = result(world, "video_packed", frames=frames,
                                  ref_mode=mode)
    jmv, jbl, jbits, jhist = jax_packed(fa, case)
    assert np.array_equal(bits, jbits)
    assert np.array_equal(hist, jhist)
    f, s = bits.shape
    n_mb = (H // s // 16) * (W // 16)
    mv_bits = np.where(np.arange(f) % gop == 0, 0, n_mb * 2 *
                       mvec_bits(MERANGE))
    start = start_bit(frames, gop)
    flat = np.stack([np.repeat(mv_bits[:, None], s, 1), bits],
                    axis=1).reshape(-1)
    base = (start + np.cumsum(flat) - flat).reshape(f, 2, s)
    for fi in range(f):
        for si in range(s):
            for kind, (got, want) in enumerate(((mvw, jmv), (blw, jbl))):
                nb = flat.reshape(f, 2, s)[fi, kind, si]
                n = ((base[fi, kind, si] & 31) + nb + 31) >> 5 if nb else 0
                assert np.array_equal(got[fi, si, :n].view(np.uint32),
                                      want[fi, si, :n]), (fi, si, kind)


def test_step_matches_jax(world):
    fa, _ = world
    got = result(world, "video_step", frames=LAYOUT)
    step = jax_vs.make_sharded_video_step(jax_make_mesh(4, frame_axis=fa), 4,
                                          MERANGE, mvec_bits(MERANGE))
    want = jax.block_until_ready(step(LAYOUT, QL.as_float(np.float32)))
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
