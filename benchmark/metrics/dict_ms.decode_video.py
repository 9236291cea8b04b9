"""Host milliseconds a request in the program's ``dict`` span of a video
decode (models/image.py::parse_stream: the Huffman dict parsed and
validated, and its decode table built)."""


def read(run):
    if run.workload.entry != "decode_frames":
        return None
    return run.span_ms("dict")
