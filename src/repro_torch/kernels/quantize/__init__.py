"""quantize kernel family: blockwise absmax int8 quantize/dequantize."""
