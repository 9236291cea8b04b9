"""Host milliseconds a request in the program's ``recon`` span of a
closed-loop clip encode (ops/video_pipeline.py::
make_encode_video_packed_recon: K5 on the I-frames and the loop over the
GOP steps, each a search_predict and a recon step, as the host enqueues
them)."""


def read(run):
    if run.workload.entry != "encode_frames_recon":
        return None
    return run.span_ms("recon")
