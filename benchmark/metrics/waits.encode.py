"""The program's ``wait`` spans a request of an encode: how many times
the host blocks on the device."""


def read(run):
    if run.direction != "encode" or not run.times:
        return None
    n = sum(1 for r in run.spans.records if r[0] == "wait")
    return n / len(run.times) if n else None
