"""Core PTQTP: packing, quantizer, model quantization."""
