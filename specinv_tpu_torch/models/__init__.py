"""Inversion algorithms: Griffin-Lim, ADMM, L-BFGS, RTISI-LA and the SPSI
seed (the JAX package's ``__all__`` order)."""
from .admm import ADMM, admm  # noqa: F401
from .lbfgs import L_BFGS, l_bfgs  # noqa: F401
from .rtisi_la import RTISI_LA, RTISIStreamer, rtisi_la  # noqa: F401
from .griffin_lim import griffin_lim  # noqa: F401
from .phase_init import phase_init  # noqa: F401

__all__ = ["ADMM", "admm", "L_BFGS", "l_bfgs", "RTISI_LA", "RTISIStreamer", "rtisi_la",
           "griffin_lim", "phase_init"]
