"""Host milliseconds a request of an encode in its ``device video encode``
or ``device batch encode`` spans' own time: each such span's duration less
the union of the program's spans that lie inside its interval (the waits
and cuts of a long clip's chunk loop), which leaves the host's enqueueing
of the device work."""

LABELS = ("device video encode", "device batch encode")


def read(run):
    if run.direction != "encode" or not run.times:
        return None
    records = sorted(run.spans.records, key=lambda r: (r[1], -r[2]))
    own, found = 0.0, False
    for i, (label, s, e) in enumerate(records):
        if label not in LABELS:
            continue
        found = True
        covered, reach = 0.0, s
        for _, cs, ce in records[i + 1:]:
            if cs >= e:
                break
            if ce > e:
                continue  # not inside this span
            covered += max(0.0, ce - max(cs, reach))
            reach = max(reach, ce)
        own += e - s - covered
    if not found:
        return None
    return own / len(run.times) * 1e3
