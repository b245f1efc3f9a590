"""solve_ms: the window's wall time over the requests completed in it (a
request is one call of the entry, returned and synchronized)."""


def read(run):
    if not run.requests:
        return None
    return 1e3 * run.window_s / len(run.requests)
