"""The recon chain's least device time (roofline_recon.chain: the larger
of its f64 and integer terms) over the device time its kernels took a
request (the union of their intervals in the profiled stretch, over the
requests profiled), in percent.  The chain's kernels, by the names the
profiler prints: K5, the search (with its prediction epilogue) and the
recon step."""

from benchmark import roofline_recon, tracing

KERNELS = ("quantize_image_kernel", "motion_search_kernel",
           "recon_step_kernel")


def read(run):
    p, wl = run.profile, run.workload
    if wl.entry != "encode_frames_recon" or p is None or not run.profiled:
        return None
    a, b = p.stretch
    kernel_s = tracing.length(tracing.merge(
        (max(s, a), min(e, b)) for name, kind, s, e in p.ops
        if kind == "kernel" and e > a and s < b
        and any(k in name for k in KERNELS))) / run.profiled
    if kernel_s <= 0.0:
        return None
    c = wl.config
    least = roofline_recon.chain(c["frame_count"], c["height"], c["width"],
                                 c["gop"], c["merange"])["least_s"]
    return 100.0 * least / kernel_s
