"""Host milliseconds a request in the program's ``staging`` span of a
video decode (models/image.py::parse_stream: the staging buffer of the one
upload, its parts laid out and copied in)."""


def read(run):
    if run.workload.entry != "decode_frames":
        return None
    return run.span_ms("staging")
