"""driver.pack_ms: the program's per-call packing of the operands onto the
device, from its own spans: ``cpkrylov.operands`` (``driver.solve``: A, B,
C and b, with the synchronize that ends it) and ``cpkrylov.mixed.pack``
(``prepare_mixed_device``: the df64 packs and the b split).  Mean a traced
request, ms."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, spans.OPERANDS, spans.MIXED_PACK)
