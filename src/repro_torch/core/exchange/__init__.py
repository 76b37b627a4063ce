"""Exchange-scheme registry.  Ported: ``local`` (the P=1 scheme of the
monolithic ``simulate()``)."""

from .base import (NOT_PORTED, ExchangeScheme, Topology, available_schemes,
                   get_scheme, register_scheme)
from . import local  # noqa: F401 (register)

__all__ = ["ExchangeScheme", "NOT_PORTED", "Topology", "available_schemes",
           "get_scheme", "register_scheme"]
