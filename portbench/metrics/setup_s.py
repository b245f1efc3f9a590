"""setup_s: from the start of the process to the start of the window:
CUDA context, kernel build (the first run in a checkout), system and pool
generation, the set-up preconditioner, warm requests."""


def read(run):
    return run.setup_s
