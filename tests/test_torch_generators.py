"""The generator nodes (``nodes/generators.py``) and the port's threefry
(``ops/noise.py``) held against the JAX package on the CPU.

The noise must be JAX's own bits: ``jax.random``'s threefry2x32 in JAX
0.9's partitionable mode, computed by the port on int64 masked to 32 bits.
Keys, raw bits and the uniform draw are compared bit for bit for several
seeds and stream samples, across the 2^32 wrap of the stream clock.  K6's
launch geometry (``noise.launch_geometry``) must draw every element of
every lane once, and the plain version in the kernel's order
(``_noise_by_tiles``) must give JAX's bits.  The nodes run
B=4 instances (``vmap`` on the JAX side) at 1e-6 absolute: the pink
filter's scan equals JAX's bit for bit, the LFO's sine may differ by an
ulp of torch's and XLA's sin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu import nodes as jn
from firewheel_tpu.core import node as jnode
from firewheel_tpu.ops.dynamics import sample_scan as jax_sample_scan
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core import node as tnode
from firewheel_tpu_torch.ops import dynamics as td
from firewheel_tpu_torch.ops import noise
from test_torch_nodes import B, F, SR, TOL, _assert_trees_close, _normalize

SEEDS = np.array([0, 1, 11, 0x7FFFFFFF, 0xFFFFFFFF, 123456789], np.uint32)
#: stream samples: the start, a block in, the last blocks before the 2^32
#: wrap of the clock, and its last sample
SAMPLES = [0, 128, 2**32 - 256, 2**32 - 128, 2**32 - 1]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("sample", SAMPLES)
def test_keys_and_bits_equal_jax(sample):
    seeds = torch.from_numpy(SEEDS.astype(np.int64))
    data = torch.tensor(sample, dtype=torch.int64)
    key = noise.fold_in(noise.prng_key(seeds), data)

    def jkey(seed):
        return jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(sample))

    jkeys = jax.vmap(jkey)(SEEDS)
    np.testing.assert_array_equal(torch.stack(key, -1).numpy().astype(np.uint32),
                                  np.asarray(jkeys))
    bits = noise.random_bits(key, 3 * 67, seeds.device)
    jbits = jax.vmap(lambda k: jax.random.bits(k, (3, 67), jnp.uint32))(jkeys)
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32).reshape(-1, 3, 67),
                                  np.asarray(jbits))


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("frames", [128, 1, 100])
def test_noise_uniform_equals_jax_bit_for_bit(sample, frames):
    def draw(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(sample))
        return jax.random.uniform(key, (2, frames), jnp.float32, minval=-1.0,
                                  maxval=1.0)

    want = jax.vmap(draw)(SEEDS)
    got = noise.noise_uniform(torch.from_numpy(SEEDS.astype(np.int64)),
                              torch.tensor(sample, dtype=torch.int64), 2, frames)
    assert got.shape == (len(SEEDS), 2, frames) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got.min() >= -1.0 and got.max() < 1.0


def test_threefry_known_answer():
    """The Threefry-2x32 test vector (Salmon et al., 20 rounds): key and
    counts 0 → 0x6b200159, 0x99ba4efe; JAX's threefry2x32 says the same."""
    y0, y1 = noise.threefry2x32(0, 0, 0, 0)
    assert (y0, y1) == (0x6B200159, 0x99BA4EFE)
    from jax._src import prng

    z = np.zeros(1, np.uint32)
    j0, j1 = prng.threefry2x32_p.bind(z, z, z, z)
    assert (int(j0[0]), int(j1[0])) == (y0, y1)


def _thread_elements(geo, lanes, per_lane):
    """``(lane, element)`` of every element each thread of ``geo``'s launch
    draws, by K6's index math: int64 ``[threads, elems]`` each, -1 where a
    thread's run passes its lane's end or it has no lane."""
    bx, by, ty, tx = torch.meshgrid(
        *(torch.arange(n) for n in (*geo.grid, geo.cta_lanes, geo.lane_threads)),
        indexing="ij")
    lane = (bx * geo.cta_lanes + ty).reshape(-1, 1)
    i = ((by * geo.lane_threads + tx) * geo.elems).reshape(-1, 1) + torch.arange(geo.elems)
    live = (lane < lanes) & (i < per_lane)
    return torch.where(live, lane, -1), torch.where(live, i, -1)


def _noise_by_tiles(seed, stream_sample, channels, frames):
    """``noise.noise_uniform`` in K6's order: each lane's key hashed once,
    then every thread's run of elements found by :func:`_thread_elements`
    and hashed from the counts ``(0, i)``."""
    lanes, per_lane = seed.numel(), channels * frames
    k0, k1 = noise.fold_in(noise.prng_key(seed.reshape(-1)), stream_sample)
    lane, i = _thread_elements(noise.launch_geometry(lanes, per_lane), lanes, per_lane)
    live = lane >= 0
    lane, i = lane[live], i[live]
    y0, y1 = noise.threefry2x32(k0[lane], k1[lane], 0, i)
    out = torch.empty(lanes * per_lane, dtype=torch.float32)
    out[lane * per_lane + i] = noise.uniform_from_bits(y0 ^ y1)
    return out.reshape(*seed.shape, channels, frames)


@pytest.mark.parametrize("per_lane", [1, 100, 127, 256, 257, 512])
@pytest.mark.parametrize("lanes", [1, 3, 8192])
def test_launch_geometry_draws_every_element_once(lanes, per_lane):
    """Every (lane, element) of K6's launch is drawn by exactly one thread,
    each thread's run lies in one lane, and in a large draw rows of a
    multiple of a run go out as whole runs of 16-byte stores."""
    geo = noise.launch_geometry(lanes, per_lane)
    assert geo.elems == next(e for n, e in noise.RUNS if lanes * per_lane >= n)
    assert geo.lane_threads * geo.cta_lanes == noise.THREADS
    lane, i = _thread_elements(geo, lanes, per_lane)
    live = lane >= 0
    flat = (lane * per_lane + i)[live]
    assert torch.equal(torch.bincount(flat, minlength=lanes * per_lane),
                       torch.ones(lanes * per_lane, dtype=torch.int64))
    first = lane[:, :1]
    assert torch.all((lane == first) | ~live)
    assert torch.all((i[:, 1:] == i[:, :1] + torch.arange(1, geo.elems)) | ~live[:, 1:])
    if per_lane % geo.elems == 0 and geo.elems % 4 == 0:
        used = live.any(1)
        assert torch.all(live[used]) and torch.all(flat.reshape(-1, geo.elems)[:, 0] % 4 == 0)


@pytest.mark.parametrize("lanes, per_lane", [(1, 2**32), (2**16, 2**16), (1, 2**27 + 1),
                                             (0, 256)])
def test_launch_geometry_refuses_past_its_indices(lanes, per_lane):
    """A lane of 2^32 elements (its counts' high word not 0), 2^32 elements
    in all, more than 65 535 CTAs along a lane, or nothing to draw."""
    with pytest.raises(ValueError, match="noise_uniform"):
        noise.launch_geometry(lanes, per_lane)


@pytest.mark.parametrize("sample", [2**32 - 128, 0])
@pytest.mark.parametrize("lanes, channels, frames", [
    (8192, 2, 128), (1, 2, 256), (3, 1, 1), (5, 2, 127), (33, 2, 100), (2, 3, 257),
    (1024, 2, 127), (300, 3, 257), (4200, 2, 127)])
def test_noise_by_tiles_equals_jax_bit_for_bit(lanes, channels, frames, sample):
    """K6's order (each lane's key once, each thread's run by the
    geometry's index math) against ``jax.random.uniform(fold_in(PRNGKey(
    seed), sample), ...)`` at the bus's and the stream's draws, ragged
    rows (small draws, one element a thread; larger ones, runs of 4 and 8
    cut by the row's end), and the two blocks around the clock's wrap."""
    rng = np.random.default_rng(14)
    seeds = rng.integers(0, 2**32, lanes, dtype=np.uint64).astype(np.uint32)
    seeds[: len(SEEDS)] = SEEDS[:lanes]

    def draw(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(sample))
        return jax.random.uniform(key, (channels, frames), jnp.float32, minval=-1.0,
                                  maxval=1.0)

    want = jax.vmap(draw)(seeds)
    got = _noise_by_tiles(torch.from_numpy(seeds.astype(np.int64)),
                          torch.tensor(sample, dtype=torch.int64), channels, frames)
    assert got.shape == (lanes, channels, frames)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_uniform_as_one_fma_is_jax_conversion():
    """K6 forms the float as fmaf(f, 2, -3) for f = 1.mantissa in [1, 2):
    for every one of the 2^23 mantissas that is exactly
    ``uniform_from_bits`` (JAX's (f - 1)·2 + (-1), then its max with -1)."""
    mantissa = torch.arange(2**23, dtype=torch.int64)
    f = (mantissa | 0x3F800000).to(torch.int32).view(torch.float32)
    fma = (2.0 * f.double() - 3.0).float()  # exact in float64: one rounding, as fmaf
    want = noise.uniform_from_bits(mantissa << 9)
    assert torch.equal(fma.view(torch.int32), want.view(torch.int32))


def _pink_jax(z, w):
    def step(z, w):
        b0 = 0.99765 * z[:, 0] + w * 0.0990460
        b1 = 0.96300 * z[:, 1] + w * 0.2965164
        b2 = 0.57000 * z[:, 2] + w * 1.0526913
        y = (b0 + b1 + b2 + w * 0.1848) * 0.25
        return jnp.stack([b0, b1, b2], axis=-1), y
    return jax_sample_scan(step, z, w)


def test_pink_scan_equals_jax_bit_for_bit():
    """``scan_lanes(PINK)`` against the noise kernel's scan body on the same
    white noise ([B, ch] lanes; 3 poles a lane, started anywhere)."""
    rng = np.random.default_rng(8)
    w = rng.uniform(-1.0, 1.0, (B, 2, F)).astype(np.float32)
    z = rng.uniform(-20.0, 20.0, (B, 2, 3)).astype(np.float32)
    jz, jy = jax.vmap(_pink_jax)(z, w)
    tz, ty = td.scan_lanes(td.PINK, torch.from_numpy(w), torch.from_numpy(z).unbind(-1), ())
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(torch.stack(tz, -1).numpy(), np.asarray(jz))


def run_blocks(jnode_obj, tnode_obj, nout, params, state, samples, frames=F):
    """Blocks at the given stream samples through both kernels (0 inputs);
    outputs, masks and state compared after each."""
    jp = jnode_obj.activate(SR, F, 0, nout)
    tp = tnode_obj.activate(SR, F, 0, nout)
    x = np.zeros((B, 0, frames), np.float32)
    m = np.zeros((B, 0), bool)
    for s in samples:
        jout, jst, jmask = jax.vmap(jp.kernel, in_axes=(0, 0, 0, 0, None))(
            params, state, jnp.asarray(x), jnp.asarray(m),
            jnode.BlockInfo.make(stream_sample=s))
        tout, tst, tmask = tp.kernel(
            params_from_jax(params, "cpu"), state_from_jax(state, "cpu"),
            torch.from_numpy(x), torch.from_numpy(m),
            tnode.BlockInfo.make(stream_sample=s))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        _assert_trees_close(state_to_numpy(tst), _normalize(jst))
        state = jax.tree.map(np.asarray, jst)
    return tout.numpy()


@pytest.mark.parametrize("color", ["white", "pink"])
@pytest.mark.parametrize("frames", [F, 100])
def test_noise_node(color, frames):
    """Per-instance seeds, gains and enables; three blocks that cross the
    2^32 wrap of the stream clock; a partial block of 100 frames."""
    rng = np.random.default_rng(9)
    params = {
        "gain": rng.uniform(0.05, 1.0, B).astype(np.float32),
        "enabled": np.array([True, False, True, True]),
        "seed": SEEDS[:B].copy(),
    }
    state = {"pink": rng.uniform(-5.0, 5.0, (B, 2, 3)).astype(np.float32)}
    out = run_blocks(jn.NoiseNode(color, seed=3), tn.NoiseNode(color, seed=3), 2,
                     params, state, [2**32 - 2 * frames, 2**32 - frames, 0], frames)
    assert np.all(out[1] == 0.0) and np.abs(out[0]).max() > 0.01


@pytest.mark.parametrize("shape", ["sine", "triangle", "saw", "square"])
def test_lfo_node(shape):
    rng = np.random.default_rng(10)
    node_j = jn.LFONode(shape, 3.0, 0.5, 0.25)
    node_t = tn.LFONode(shape, 3.0, 0.5, 0.25)
    params = {k: np.broadcast_to(np.asarray(v), (B,)).copy()
              for k, v in node_j.activate(SR, F, 0, 2).collect_params().items()}
    params["inc"] = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    params["depth"] = rng.uniform(0.0, 2.0, B).astype(np.float32)
    state = {"phase": rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)}
    run_blocks(node_j, node_t, 2, params, state, [0, F])


@pytest.mark.parametrize("make", [lambda n: n.NoiseNode("pink", -14.0, True, 11),
                                  lambda n: n.NoiseNode("white", -6.0, False, 2**32 + 5),
                                  lambda n: n.LFONode("saw", 0.5, 0.3, 0.1)])
def test_params_and_state_trees_round_trip(make):
    jp, tp = make(jn).activate(SR, F, 0, 2), make(tn).activate(SR, F, 0, 2)
    jparams = {k: np.asarray(v) for k, v in jp.collect_params().items()}
    tparams = state_to_numpy(params_from_jax(tp.collect_params(), "cpu"))
    assert jparams.keys() == tparams.keys()
    for k in jparams:
        assert tparams[k].dtype == jparams[k].dtype, k
        np.testing.assert_array_equal(tparams[k], jparams[k], err_msg=k)
    jstate = jax.tree.map(np.asarray, jp.init_state())
    for got in (state_to_numpy(tp.init_state()),
                state_to_numpy(state_from_jax(jstate, "cpu"))):
        for k in jstate:
            assert got[k].dtype == jstate[k].dtype and got[k].shape == jstate[k].shape
            np.testing.assert_array_equal(got[k], jstate[k])


@pytest.mark.parametrize("frames", [F, 100])
def test_pink_node_hands_its_poles_to_k5_in_place(monkeypatch, frames):
    """The pink node passes its state ``[B, 2, 3]`` to ``scan_lanes`` as it
    lies and keeps the ``[B, 2, 3]`` that comes back, with no unbind and no
    stack: the state it carries is the one the poles as three leaves give,
    bit for bit, and its noise the same."""
    from firewheel_tpu_torch.nodes import generators as tgen

    carried = []

    def spy(kind, x, carry, coefs):
        carried.append(carry)
        return td.scan_lanes(kind, x, carry, coefs)

    monkeypatch.setattr(tgen, "scan_lanes", spy)
    rng = np.random.default_rng(21)
    proc = tn.NoiseNode("pink", seed=5).activate(SR, F, 0, 2)
    params = {"gain": torch.from_numpy(rng.uniform(0.05, 1.0, B).astype(np.float32)),
              "enabled": torch.tensor([True, False, True, True]),
              "seed": torch.from_numpy(SEEDS[:B].astype(np.int64))}
    state = {"pink": torch.from_numpy(rng.uniform(-5.0, 5.0, (B, 2, 3)).astype(np.float32))}
    info = tnode.BlockInfo.make(stream_sample=2**32 - frames)
    out, new_state, _ = proc.kernel(params, state, torch.zeros((B, 0, frames)),
                                    torch.zeros((B, 0), dtype=torch.bool), info)
    assert len(carried) == 1 and carried[0] is state["pink"]
    white = noise.noise_uniform(params["seed"], info.stream_sample, 2, frames)
    poles, pink = td.scan_reference(td.PINK, white, state["pink"].unbind(-1), ())
    want = torch.stack(poles, dim=-1)
    assert new_state["pink"].shape == (B, 2, 3)
    np.testing.assert_array_equal(new_state["pink"].numpy(), want.numpy())
    gain = torch.where(params["enabled"], params["gain"], 0.0)[:, None, None]
    np.testing.assert_array_equal(out[0].numpy(), (pink * gain)[0].numpy())
