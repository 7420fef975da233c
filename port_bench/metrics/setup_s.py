"""Set-up: from the process's start to the window's (imports, the kernels'
build or cache check, weights on the card, inputs, the warm-up call)."""


def read(run):
    return run.setup_s
