"""setup_s: seconds from the process's start to the window's start (the
graph made on the card, the kernel library loaded or built, the engine
of set-up, the warm-up steps)."""


def read(run):
    return run.setup_s
