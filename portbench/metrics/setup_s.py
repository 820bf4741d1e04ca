"""Set-up: from the process's start to the window's (inputs and weights
from the seed, the program loaded, its kernels built or loaded, warmed).
Host clock."""


def read(run):
    return run.setup_s
