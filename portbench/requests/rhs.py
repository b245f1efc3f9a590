"""A fresh right-hand side a request, around the configuration's own
system: one matrix, its preconditioner built once in set-up."""


def draw(family, streams, mix):
    base = family.base()
    return base, [(base, family.rhs(r)) for r in streams]
