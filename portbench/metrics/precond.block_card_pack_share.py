"""precond.block_card_pack_share: of the blocked-substitution factors the
program built in the process, the share it placed on a CUDA device, in %
(the program's ``path_counts()``: 100 x ``block_card_packs`` /
``tri_block_builds``); None where no blocked factor was built, or the
program has no such counters."""


def read(run):
    from cpkrylov_tpu_torch.utils import profiling

    counts = getattr(profiling, "path_counts", None)
    if counts is None:
        return None
    c = counts()
    packs = c.get("block_card_packs")
    builds = c.get("tri_block_builds")
    if packs is None or not builds:
        return None
    return 100.0 * packs / builds
