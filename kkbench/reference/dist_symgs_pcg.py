"""The plain solver of the ``dist_symgs_pcg`` driver: PCG over the whole
matrix (``pcg.solve``), which is what the ranks solve together."""
from kkbench.reference.pcg import solve

__all__ = ["solve"]
