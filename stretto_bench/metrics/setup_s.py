"""setup_s: from the start of the process's set-up (before PyTorch is
imported) to the start of the measured window: imports, the kernels'
build or load, the inputs made on the card, and the warm-up."""


def read(run):
    return run.get("setup_s")
