from .adamw import adamw_init, adamw_update, global_norm
from .quantized import dequantize_state, quantize_state
from .schedules import cosine_warmup

__all__ = ["adamw_init", "adamw_update", "cosine_warmup", "dequantize_state",
           "global_norm", "quantize_state"]
