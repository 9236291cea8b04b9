"""The Huffman dict kernel (csrc/huffman.cu: the bitonic sort of the
leaves, the merge in rounds by one warp or serially for few leaves, the
pointer jumping, the 15-bit limit, the ranks by __match_any_sync) run on
the host through tools/emulate_dict.py, which compiles huffman.cu with g++
against a small emulation of CUDA, and held against the port's plain
version word for word: the kernel's logic without a card, on one ragged
batch of every kind of histogram (a CTA a stream) and on one stream.

Skipped only where g++ is absent.
"""

import importlib.util
import pathlib
import shutil

import pytest

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "emulate_dict.py"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{label: equal to the plain version} of the tool's check, its
    library built in a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    spec = importlib.util.spec_from_file_location("emulate_dict", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    mod.check(mod.build(tmp_path_factory.mktemp("emulate_dict")),
              lambda label, ok: got.setdefault(label, ok))
    return got


@pytest.mark.parametrize("part", ["batch", "one stream"])
def test_emulated_dict_equals_its_plain_version(results, part):
    mine = {k: ok for k, ok in results.items() if k.startswith(part + ":")}
    assert mine and all(mine.values()), {k: ok for k, ok in mine.items()
                                         if not ok}


@pytest.mark.parametrize("label", [
    "fibonacci chain of 31", "fibonacci chain of 33", "pow2 chain of 31",
    "refused", "40 ones, 40 twos", "256x128 image"])
def test_emulated_dict_paths(results, label):
    """The serial merge (31 leaves) and the rounds (33), each through the
    15-bit limit; a refused stream; ties whose rounds pair an odd count;
    an image's inner stream."""
    mine = [ok for k, ok in results.items()
            if k.startswith(f"batch: {label} (")]
    assert mine == [True]
