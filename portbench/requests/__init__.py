"""What a request is, one module a kind, found by the ``request`` of a
traffic mix (``mixes/<mix>.json``).

A kind's module defines ``draw(family, streams, mix)``: the set-up system
(or None where nothing is built in set-up) and the run's pool, one
``(system, rhs)`` a stream of ``streams`` (one seeded generator each).  It
may define ``call(solve, system, rhs, **kw)`` to change how a request
calls the entry; without it a request is ``solve(method, rhs, A, B, C, G,
**kw)``.  The mix's ``params`` reach both through ``mix``.
"""
