"""Inversion algorithms (ported so far: Griffin-Lim, ADMM, RTISI-LA and the
SPSI seed)."""
from .admm import ADMM, admm  # noqa: F401
from .griffin_lim import griffin_lim  # noqa: F401
from .phase_init import phase_init  # noqa: F401
from .rtisi_la import RTISI_LA, RTISIStreamer, rtisi_la  # noqa: F401
