"""Inversion algorithms (ported so far: Griffin-Lim and the SPSI seed)."""
from .griffin_lim import griffin_lim  # noqa: F401
from .phase_init import phase_init  # noqa: F401
