"""Distribution layer: the gradient compression wire format (the
sharding and the collectives come with the scale-out slice)."""
from repro_torch.parallel.compress import dequantize_int8, quantize_int8

__all__ = ["dequantize_int8", "quantize_int8"]
