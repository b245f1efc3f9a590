"""Linear-operator wrappers."""
