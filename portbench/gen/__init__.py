"""Frozen numpy/scipy copies of the port's system generators, one module a
family, found by the ``family`` of a configuration file."""
