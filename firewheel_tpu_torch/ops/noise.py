"""Counter-based random bits: JAX's threefry2x32, bit for bit.

``NoiseNode`` (``firewheel_tpu/nodes/generators.py:85-90``) draws

    jax.random.uniform(fold_in(PRNGKey(seed), stream_sample), (ch, F),
                       minval=-1.0, maxval=1.0)

every block.  The port computes the same bits itself, in the mode of JAX
0.9 (``jax_threefry_partitionable`` on, its default), from
``jax/_src/prng.py`` and ``jax/_src/random.py``:

* ``PRNGKey(seed)`` of a uint32 seed is the key ``(0, seed)``;
* ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
* the bits of element ``i`` (row-major) of a shape are ``x0 ^ x1`` of
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1, scales to ``[minval, maxval)`` and takes ``max(minval, ·)``.

* :func:`noise_uniform_reference` — the plain version, on int64 tensors
  masked to 32 bits (the port has no uint32 arithmetic on the CPU).
* :func:`noise_uniform` — the wrapper.  CPU tensors run the plain version;
  CUDA tensors launch ``csrc/noise.cu`` (K6, on uint32) or raise.  The two
  are integer-exact and agree bit for bit.
* :func:`launch_geometry` — K6's launch: each thread draws a run of
  consecutive elements of one lane (8, 4 or 1 by the size of the draw,
  ``RUNS``), a CTA holds whole lanes side by side (or a tile of a long
  one), so the kernel hashes each lane's key once a CTA and needs no
  division.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import CudaLibrary

__all__ = [
    "threefry2x32",
    "prng_key",
    "fold_in",
    "random_bits",
    "uniform_from_bits",
    "noise_uniform",
    "noise_uniform_reference",
    "Geometry",
    "launch_geometry",
    "RUNS",
    "THREADS",
    "LIBRARY",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


#: ``(elements in the draw from, elements a thread)``, largest first: the
#: consecutive elements of one lane a thread of K6 draws.  A run of 8 (two
#: 16-byte stores) shares a thread's overhead among the most hashes once
#: the draw fills the card with it (the bus's 2^21 elements at B=8192); 4
#: in a smaller draw (the hybrid's 2^18 at B=1024), where 8 leaves SMs idle;
#: 1 where the launch's latency bounds the draw (the stream's 512), which
#: then spreads over the most threads with the shortest chains.  Chosen by
#: device time on an H100 (PERF.md §6)
RUNS = ((2**20, 8), (2**16, 4), (0, 1))
#: threads a CTA of K6
THREADS = 256
_MAX_GRID_Y = 65535


def _bind(lib):
    fn = lib.fw_noise_uniform
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_int64] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


#: ``csrc/noise.cu``, built with nvcc at first use
LIBRARY = CudaLibrary("fw_noise", "noise.cu", (), _bind)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counts ``(x0, x1)`` under
    the key ``(k0, k1)``: int64 tensors (or ints) holding uint32 values,
    broadcasting together.  Returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey`` of a uint32 seed: ``(0, seed)``."""
    return seed & 0, seed & _M32


def fold_in(key, data):
    """``jax.random.fold_in``: the key hashed with ``(0, data)``."""
    return threefry2x32(key[0], key[1], data & 0, data & _M32)


def random_bits(key, count: int, device):
    """``random_bits(key, 32, shape)`` for a shape of ``count`` elements,
    flattened: int64 ``[..., count]`` for a key of shape ``[...]``."""
    i = torch.arange(count, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0][..., None], key[1][..., None], i >> 32, i & _M32)
    return y0 ^ y1


def uniform_from_bits(bits):
    """``jax.random.uniform(..., minval=-1.0, maxval=1.0)``'s float32 from 32
    random bits (int64): ``max(-1, u·2 + (-1))`` for ``u`` in [0, 1)."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min((one - 1.0) * 2.0 - 1.0, -1.0)


class Geometry(NamedTuple):
    """K6's launch for ``lanes`` rows of ``per_lane`` elements."""

    #: consecutive elements of one lane a thread draws
    elems: int
    #: threads along a lane in a CTA (``blockDim.x``)
    lane_threads: int
    #: lanes a CTA (``blockDim.y``): ``lane_threads * cta_lanes == THREADS``
    cta_lanes: int
    #: CTAs: ``(lane groups, tiles along a lane)``
    grid: tuple


def launch_geometry(lanes: int, per_lane: int) -> Geometry:
    """K6's launch geometry: a run of elements a thread by the draw's size
    (``RUNS``), as many threads along a lane as its runs need (a power of
    two, at most ``THREADS``), the rest of the CTA's threads on the next
    lanes.  Raises ``ValueError`` for
    a shape the kernel's 32-bit indices do not hold (``lanes * per_lane``
    from 2^32 on, which covers a lane of 2^32 elements, whose counts'
    high word would not be 0) or whose tiles along a lane pass the grid's
    65 535."""
    if lanes < 1 or per_lane < 1:
        raise ValueError(f"noise_uniform: no elements to draw ({lanes} x {per_lane})")
    if lanes * per_lane >= 2**32:
        raise ValueError(f"noise_uniform: {lanes} x {per_lane} elements pass the "
                         "kernel's 32-bit indices")
    elems = next(e for at_least, e in RUNS if lanes * per_lane >= at_least)
    runs = -(-per_lane // elems)
    lane_threads = min(1 << (runs - 1).bit_length(), THREADS)
    cta_lanes = THREADS // lane_threads
    grid = (-(-lanes // cta_lanes), -(-runs // lane_threads))
    if grid[1] > _MAX_GRID_Y:
        raise ValueError(f"noise_uniform: a lane of {per_lane} elements needs "
                         f"{grid[1]} CTAs along it, past the grid's {_MAX_GRID_Y}")
    return Geometry(elems, lane_threads, cta_lanes, grid)


def _check(seed, stream_sample):
    if not isinstance(seed, torch.Tensor) or seed.dtype != torch.int64:
        raise TypeError("noise_uniform: seed must be an int64 tensor (uint32 values)")
    if not isinstance(stream_sample, torch.Tensor) or stream_sample.ndim != 0:
        raise TypeError("noise_uniform: stream_sample must be a 0-dim tensor")


def noise_uniform_reference(seed, stream_sample, channels: int, frames: int):
    """Plain version of :func:`noise_uniform`."""
    _check(seed, stream_sample)
    sample = stream_sample.to(device=seed.device, dtype=torch.int64)
    key = fold_in(prng_key(seed), sample)
    bits = random_bits(key, channels * frames, seed.device)
    return uniform_from_bits(bits).reshape(*seed.shape, channels, frames)


def noise_uniform(seed, stream_sample, channels: int, frames: int):
    """The noise node's white draw: ``uniform(fold_in(PRNGKey(seed[...]),
    stream_sample), (channels, frames), -1, 1)`` for every element of
    ``seed`` (int64 holding uint32 seeds, one per instance) →
    ``f32[..., channels, frames]``.  ``stream_sample``: a 0-dim int64 tensor,
    the block's first sample on the 32-bit clock.

    CPU tensors run :func:`noise_uniform_reference`; CUDA tensors launch K6
    by :func:`launch_geometry` (which raises for a shape past its 32-bit
    indices) and add one to ``noise_uniform.launches``."""
    _check(seed, stream_sample)
    if seed.device.type == "cpu":
        return noise_uniform_reference(seed, stream_sample, channels, frames)
    if seed.device.type != "cuda":
        raise ValueError(f"noise_uniform: unsupported device {seed.device}")
    seeds = seed.contiguous()
    sample = stream_sample.to(device=seed.device, dtype=torch.int64)
    out = torch.empty((*seed.shape, channels, frames), dtype=torch.float32,
                      device=seed.device)
    if out.numel() == 0:
        return out
    geo = launch_geometry(seeds.numel(), channels * frames)
    lib = LIBRARY.load()
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        err = lib.fw_noise_uniform(seeds.data_ptr(), sample.data_ptr(), out.data_ptr(),
                                   seeds.numel(), channels * frames, geo.elems,
                                   geo.lane_threads, geo.cta_lanes, *geo.grid, stream)
    if err != 0:
        raise RuntimeError(f"noise_uniform: kernel launch failed (cudaError {err})")
    noise_uniform.launches += 1
    return out


#: kernel launches since the counter was last set to 0
noise_uniform.launches = 0
