"""kernel.scan_grid_share: of the B6 scans the program launched in the
process, the share that ran on the persistent grid and not on one cluster,
in % (the program's ``path_counts()``: 100 x ``scan_grid_launches`` /
(``scan_grid_launches`` + ``scan_cluster_launches``)); None where no scan
was launched, or the program has no such counters."""


def read(run):
    from cpkrylov_tpu_torch.utils import profiling

    counts = getattr(profiling, "path_counts", None)
    if counts is None:
        return None
    c = counts()
    grid = c.get("scan_grid_launches")
    cluster = c.get("scan_cluster_launches")
    if grid is None or cluster is None or not grid + cluster:
        return None
    return 100.0 * grid / (grid + cluster)
