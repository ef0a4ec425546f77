"""Plain DSP for the references, in PyTorch on the CPU, in any float dtype.

Every function takes the working dtype ``dt``: float64 for the reference,
and a lower precision for the control (the same code computed in bfloat16).
Nothing here imports the program under test: the semantics are the
documented ones of the nodes (BillyDM/firewheel's ``basic_nodes`` and
``param/smoother.rs``), written out again.

Long recurrences run as block matrices so that they take seconds, not
minutes: a biquad with fixed coefficients maps a segment of L samples and
its two state words to the segment's output and the next state by matrices
built from its impulse and state responses, an exact rewriting of the
recurrence.  An FIR is the linear convolution by one long FFT, which is
not the program's partitioned engine.
"""

from __future__ import annotations

import math

import torch

#: segment length of the block-matrix recurrences
SEGMENT = 128
SMOOTH_SECS = 0.01
SETTLE_EPSILON = 1e-5


def smoother_ramps(start, target, frames: int, sample_rate: int, dt, blocks: int):
    """The parameter smoother (one pole, 10 ms, settle at 1e-5) from
    ``start`` toward a fixed ``target`` (same shape), block by block, for
    at most ``blocks`` blocks → ``(values [..., M·frames], M)``: every value
    after the first M blocks is ``target`` exactly (M = ``blocks`` where a
    ramp has not settled by then, as one in a coarse dtype may never).

    Each block: a target that differs from the last set one starts a ramp
    ``x + (last − x)·b^k``, k = 1..frames, with ``b = exp(−1/(0.01·sr))``;
    a ramp whose first value lies within 1e-5 of the target settles, and
    the block holds the target; an idle smoother holds its last value."""
    start = torch.as_tensor(start, dtype=dt)
    target = torch.as_tensor(target, dtype=dt)
    b = math.exp(-1.0 / (SMOOTH_SECS * sample_rate))
    k = torch.arange(1, frames + 1, dtype=torch.float64)
    powers = torch.pow(torch.tensor(b, dtype=torch.float64), k).to(dt)
    last = start.clone()
    active = target != start
    limit, blocks = blocks, []
    while bool(active.any()) and len(blocks) < limit:
        ramp = target[..., None] + (last - target)[..., None] * powers
        settled = active & (torch.abs(target - ramp[..., 0]) < SETTLE_EPSILON)
        values = torch.where(settled[..., None], target[..., None],
                             torch.where(active[..., None], ramp, last[..., None]))
        last = torch.where(settled, target, torch.where(active, ramp[..., -1], last))
        active = active & ~settled
        blocks.append(values)
    if not blocks:
        return target[..., None][..., :0], 0
    return torch.cat(blocks, dim=-1), len(blocks)


def lowpass_coeffs(freq_hz, q, sample_rate: int, dt):
    """RBJ cookbook lowpass → ``(b0, b1, b2, a1, a2)``, normalised by a0."""
    f = torch.as_tensor(freq_hz, dtype=dt)
    w0 = 2.0 * math.pi * f / sample_rate
    c, s = torch.cos(w0), torch.sin(w0)
    alpha = s / (2.0 * q)
    a0 = 1.0 + alpha
    b1 = (1.0 - c) / a0
    b0 = b1 * 0.5
    return b0, b1, b0, (-2.0 * c) / a0, (1.0 - alpha) / a0


def biquad(x, coeffs, dt):
    """Biquad (transposed direct form II, zero initial state) over ``x
    [R, N]``, each row its own ``coeffs`` ``(b0, b1, b2, a1, a2)`` of shape
    ``[R]``: ``y = b0·x + z1; z1 = b1·x − a1·y + z2; z2 = b2·x − a2·y``."""
    r, n = x.shape
    L = SEGMENT
    segs = -(-n // L)
    xs = torch.nn.functional.pad(x.to(dt), (0, segs * L - n)).reshape(r, segs, L)
    b0, b1, b2, a1, a2 = (c.to(dt).reshape(r, 1) for c in coeffs)
    # three runs of L steps side by side: an impulse from rest, and no input
    # from the states (1, 0) and (0, 1)
    z1 = torch.zeros((r, 3), dtype=dt)
    z2 = torch.zeros((r, 3), dtype=dt)
    z1[:, 1] = 1.0
    z2[:, 2] = 1.0
    imp = torch.zeros((r, 3), dtype=dt)
    h, o, s_imp = [], [], []
    for i in range(L):
        imp.zero_()
        if i == 0:
            imp[:, 0] = 1.0
        y = b0 * imp + z1
        z1, z2 = b1 * imp - a1 * y + z2, b2 * imp - a2 * y
        h.append(y[:, 0])
        o.append(y[:, 1:])
        s_imp.append(torch.stack([z1[:, 0], z2[:, 0]], -1))
    h = torch.stack(h, -1)                      # [R, L]
    o = torch.stack(o, 1)                       # [R, L, 2]
    phi = torch.stack([z1[:, 1:], z2[:, 1:]], 1)  # [R, 2 (new), 2 (old)]
    gamma = torch.stack(s_imp[::-1], 1)         # [R, L (input j), 2]
    idx = torch.arange(L)
    lag = idx[:, None] - idx[None, :]
    toeplitz = torch.where(lag >= 0, h[:, lag.clamp(min=0)], torch.zeros((), dtype=dt))
    y0 = torch.einsum("rsj,rij->rsi", xs, toeplitz)
    zx = torch.einsum("rsj,rjk->rsk", xs, gamma)
    states = torch.zeros((r, segs, 2), dtype=dt)
    z = torch.zeros((r, 2), dtype=dt)
    for s in range(segs):
        states[:, s] = z
        z = torch.einsum("rkl,rl->rk", phi, z) + zx[:, s]
    y = y0 + torch.einsum("rsk,rik->rsi", states, o)
    return y.reshape(r, segs * L)[:, :n]


def echo(x, delay: int, feedback: float, wet, dry: float, dt):
    """Feedback echo over ``x [R, N]``, the line at rest at the start:
    ``e[n] = x[n] + fb·e[n−D]``, ``y[n] = dry·x[n] + wet·e[n−D]``.
    ``wet`` is a number or ``[R]``."""
    x = x.to(dt)
    r, n = x.shape
    e = torch.zeros_like(x)
    for s in range(0, n, delay):
        seg = x[:, s:s + delay]
        if s >= delay:
            e[:, s:s + delay] = seg + feedback * e[:, s - delay:s - delay + seg.shape[1]]
        else:
            e[:, s:s + delay] = seg
    delayed = torch.nn.functional.pad(e, (delay, 0))[:, :n]
    wet = torch.as_tensor(wet, dtype=dt).reshape(-1, 1) if torch.is_tensor(wet) else wet
    return dry * x + wet * delayed


def fir(x, taps, dt):
    """Causal FIR ``y[n] = Σ_k taps[k]·x[n−k]`` over ``x [R, N]``, each row
    its own ``taps [R, T]``, the input at rest before 0: the linear
    convolution, by one FFT of length ≥ N + T − 1 a row.  ``torch.fft``
    takes float32 and float64; in a coarser ``dt`` the input and the taps
    are rounded to ``dt``, the transform runs in float32 (a coarse dtype's
    products are accumulated in float32, as its matrix units do) and the
    result is rounded to ``dt``."""
    r, n = x.shape
    work = dt if dt in (torch.float32, torch.float64) else torch.float32
    xs = x.to(dt).to(work)
    hs = taps.to(dt).to(work)
    size = 1 << (n + taps.shape[-1] - 2).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(xs, n=size) * torch.fft.rfft(hs, n=size), n=size)
    return y[:, :n].to(dt)


def clip(x, threshold_db: float):
    """Hard clip at ±10^(dB/20)."""
    t = 10.0 ** (threshold_db / 20.0)
    return x.clamp(-t, t)


def pcm16(x):
    """f32 audio → int16 PCM: ``round(clamp(x, ±1)·32767)``, ties to even,
    in the working dtype (a coarse dtype may round 32767 up to 32768: the
    result is held to the int16 range before the cast)."""
    y = torch.round(x.clamp(-1.0, 1.0) * 32767.0)
    return y.to(torch.float32).clamp(-32767.0, 32767.0).to(torch.int16)
