"""Host milliseconds a request in the program's ``splice`` span of a clip
encode (models/video.py::encode_frames past 32 frames: the header and the
chunks' bytes concatenated at bit granularity on the host)."""


def read(run):
    if run.workload.entry != "encode_frames":
        return None
    return run.span_ms("splice")
