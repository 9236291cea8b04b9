"""The encode requests' least device time (roofline.py, from the request's
shapes and stream) over the device time their kernels took (the union of
kernel intervals in the profiled stretch, a request), in percent."""


def read(run):
    p = run.profile
    if run.direction != "encode" or p is None or not run.profiled:
        return None
    kernel_s = p.kernel_s() / run.profiled
    if kernel_s <= 0.0:
        return None
    return 100.0 * run.least_s / kernel_s
