"""A whole new system a request (the configuration's family at a fresh
draw: for an interior-point family, a new iterate at the same mu), its own
right-hand side with it; nothing built in set-up."""


def draw(family, streams, mix):
    return None, [(s, s.b) for s in (family.iterate(r) for r in streams)]
