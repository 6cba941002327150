"""Set-up time (host clock): from the end of ``import torch`` to the window:
the CUDA context, importing the port and building or loading its kernels,
the inputs made on the card and the warm-up.  Importing torch comes before
it: it is the same for every program and cell, and on a shared host its
time drifts by seconds from run to run (the run prints it beside)."""


def read(run):
    return run.setup_s
