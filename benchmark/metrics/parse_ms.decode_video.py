"""Host milliseconds a request in the program's ``parse`` span of a
video decode (models/video.py::plan_video: the dict, its validation, the
decode table, the header and the staging buffer)."""


def read(run):
    if run.workload.entry != "decode_frames":
        return None
    return run.span_ms("parse")
