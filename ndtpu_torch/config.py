"""Configuration dataclasses: the JAX package's own, re-exported.

``ndtpu.config`` imports only ``dataclasses``, ``json`` and ``typing`` (and
``ndtpu/__init__.py`` only sets ``__version__``), so both packages share one
definition and one JSON loader.
"""

from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,  # noqa: F401
                          MatchConfig, NDTMapConfig, PipelineConfig,
                          SolverConfig)
