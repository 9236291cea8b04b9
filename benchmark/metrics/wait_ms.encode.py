"""Host milliseconds a request in the program's ``wait`` spans of an
encode: every place the host blocks on the device (a chunk's bit total
read as a host int, the tail's lengths and copy events)."""


def read(run):
    if run.direction != "encode":
        return None
    return run.span_ms("wait")
