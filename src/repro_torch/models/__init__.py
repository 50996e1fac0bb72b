"""Model zoo: every family of the reference's architectures (dense, MoE,
the jamba hybrid, RWKV-6 and the whisper encoder-decoder), built from shared
layers (the port of `repro.models`)."""
from .model import Model, build
from .sharding import Rules

__all__ = ["Model", "Rules", "build"]
