"""Model zoo: the dense and RWKV-6 architectures, built from shared layers
(the port of `repro.models`; the moe, hybrid and encoder-decoder families
are not ported yet)."""
from .model import Model, build
from .sharding import Rules

__all__ = ["Model", "Rules", "build"]
