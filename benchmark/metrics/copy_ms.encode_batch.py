"""Host milliseconds a request in the program's ``copy`` span of a batch
encode (models/batch.py: Tail.finish, the wait for the streams' lengths,
one device-to-host copy and one ``bytes`` a stream)."""


def read(run):
    if run.workload.entry != "encode_image_batch":
        return None
    return run.span_ms("copy")
