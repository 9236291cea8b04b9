"""K2 over a batch, K4 pack_payload over one stream, a batch and byte
windows, and K4 pack_records over one stream and over segments
(csrc/pack.cu, K2's two launches), and the wire emit over the batch with
and without Huffman (csrc/wire.cu), run on the host through
tools/emulate_pack.py, which compiles pack.cu and wire.cu with g++
against a small emulation of CUDA, and held against the port's plain
versions: the kernels' logic without a card, on ragged batches (streams
of many tiles, streams with nothing to code or that fall back, one
stream and 17), pack_records' fields (random ones from bit 0 and from an
odd bit behind a prefix, a small clip's recon fields, a run of empty
records longer than a tile, ragged segments, and a width of 17, which
makes the total -1), written into dirty buffers, the emit's input dirty
past each stream.

Skipped only where g++ is absent.
"""

import importlib.util
import pathlib
import shutil

import pytest

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "emulate_pack.py"


def load_tool():
    spec = importlib.util.spec_from_file_location("emulate_pack", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL_MOD = load_tool()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The emulated library, built in a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return TOOL_MOD.build(tmp_path_factory.mktemp("emulate_pack"))


@pytest.mark.parametrize("case", list(TOOL_MOD.CASES))
def test_emulated_batch_packers_equal_their_plain_versions(lib, case):
    kinds, shape, quant = TOOL_MOD.CASES[case]
    results = {}
    TOOL_MOD.run_case(lib, case, kinds, shape, quant,
                      lambda label, ok: results.setdefault(label, ok))
    assert len(results) == 8
    assert all(results.values()), results


@pytest.mark.parametrize("case", list(TOOL_MOD.RECORD_CASES))
def test_emulated_pack_records_equals_its_plain_version(lib, case):
    assert TOOL_MOD.RECORD_CASES[case](lib)
