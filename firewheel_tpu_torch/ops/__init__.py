"""DSP primitives and the hand-written kernels."""
