"""DSP primitives and the hand-written kernels.

The names below are the JAX package's ``firewheel_tpu.ops``: pure torch
functions over ``[..., frames]`` tensors with explicit carries.  The
scans among them launch their CUDA kernels on CUDA tensors; importing this
package builds nothing and touches no device (a library is built at its
first launch)."""

from .iir import (
    BiquadCoeffs,
    biquad_allpass,
    biquad_bandpass,
    biquad_high_shelf,
    biquad_highpass,
    biquad_low_shelf,
    biquad_lowpass,
    biquad_notch,
    biquad_peaking,
    biquad_scan,
    one_pole_coeffs,
    one_pole_scan,
)
from .fft_conv import fdl_init, fdl_step, partition_ir
from .delay import comb_init, comb_step, delay_init, delay_step
from .pan import (
    equal_power_gains,
    mid_side_merge,
    mid_side_split,
    spatial_params,
)

__all__ = [
    "BiquadCoeffs",
    "biquad_allpass",
    "biquad_bandpass",
    "biquad_high_shelf",
    "biquad_highpass",
    "biquad_low_shelf",
    "biquad_lowpass",
    "biquad_notch",
    "biquad_peaking",
    "biquad_scan",
    "one_pole_coeffs",
    "one_pole_scan",
    "fdl_init",
    "fdl_step",
    "partition_ir",
    "comb_init",
    "comb_step",
    "delay_init",
    "delay_step",
    "equal_power_gains",
    "mid_side_merge",
    "mid_side_split",
    "spatial_params",
]
