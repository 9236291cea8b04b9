"""Host milliseconds a request in the program's ``restage`` span of a clip
encode (ops/huffman.py::huffman_encode: the spliced stream's bytes made
into words on the host and sent back to the device)."""


def read(run):
    if run.workload.entry != "encode_frames":
        return None
    return run.span_ms("restage")
