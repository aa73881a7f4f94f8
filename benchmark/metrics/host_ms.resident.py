"""Host milliseconds per roundtrip from the call to its return, before the
synchronize (host API and wrappers), over the whole window."""


def read(run):
    total = run.spans.get("host")
    return 1e3 * total[0] / total[1] if total and total[1] else None
