"""Host C++ for evaluation (RLE codec and mask IoU, greedy matcher), built
with g++ at first use and bound with ctypes."""
