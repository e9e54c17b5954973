"""Roofline terms and MODEL_FLOPS on the H100's data-sheet peaks."""
