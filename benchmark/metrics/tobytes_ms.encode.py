"""Host milliseconds a request in the program's ``tobytes`` spans of an
encode (ops/huffman.py::Tail.result: the pinned buffer cut into each
stream's ``bytes``)."""


def read(run):
    if run.direction != "encode":
        return None
    return run.span_ms("tobytes")
