"""Model, heads, RoI extraction and the inference API of the detector."""
