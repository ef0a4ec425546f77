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
  CUDA tensors launch ``csrc/noise.cu`` (K6, one thread an element, on
  uint32) or raise.  The two are integer-exact and agree bit for bit.
"""

from __future__ import annotations

import ctypes

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
    "LIBRARY",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _bind(lib):
    fn = lib.fw_noise_uniform
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
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
    and add one to ``noise_uniform.launches``."""
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
    lib = LIBRARY.load()
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        err = lib.fw_noise_uniform(seeds.data_ptr(), sample.data_ptr(), out.data_ptr(),
                                   seeds.numel(), channels * frames, stream)
    if err != 0:
        raise RuntimeError(f"noise_uniform: kernel launch failed (cudaError {err})")
    noise_uniform.launches += 1
    return out


#: kernel launches since the counter was last set to 0
noise_uniform.launches = 0
