"""mixed.fallback_share: of the mixed solve's unforced device loops in the
process, the share that did not converge and sent the solve to the host
loop, in % (the program's ``path_counts()``: 100 x ``mixed_fallbacks`` /
``mixed_device_loops``); None where no device loop ran, or the program has
no such counters."""


def read(run):
    from cpkrylov_tpu_torch.utils import profiling

    counts = getattr(profiling, "path_counts", None)
    if counts is None:
        return None
    c = counts()
    loops = c.get("mixed_device_loops", 0)
    if not loops:
        return None
    return 100.0 * c.get("mixed_fallbacks", 0) / loops
