"""Box ops, anchors, NMS and the hand-written kernels' wrappers."""
