"""Host milliseconds a request in the program's span that enqueues an
encode's device work: ``device batch encode`` (models/batch.py) or
``device video encode`` (models/video.py)."""


def read(run):
    if run.direction != "encode":
        return None
    return run.span_ms("device batch encode", "device video encode")
