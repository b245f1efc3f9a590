"""driver.dia_card_pack_share: of the DIA placements the program attempted
on a CUDA device in the process, the share that passed the layout gate and
packed on the card, in % (the program's ``path_counts()``: 100 x
``dia_card_packs`` / (``dia_card_packs`` + ``dia_gate_refusals``)); None
where nothing was attempted on a card, or the program has no such
counters."""


def read(run):
    from cpkrylov_tpu_torch.utils import profiling

    counts = getattr(profiling, "path_counts", None)
    if counts is None:
        return None
    c = counts()
    packs = c.get("dia_card_packs")
    refusals = c.get("dia_gate_refusals")
    if packs is None or refusals is None or not packs + refusals:
        return None
    return 100.0 * packs / (packs + refusals)
