"""The run's set-up: interpreter start to the window (imports, the built
kernels loaded or built, the records made on the card, the warm record)."""


def read(run):
    return run.setup_s
