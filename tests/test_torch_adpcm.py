"""adpcm4 egress in the port: ``ops/adpcm_device.py`` and
``BatchRenderer(output_format="adpcm4")``, held against the JAX package.

The encoder's plain version (the CPU path; K4's on the card) is integer
arithmetic: its bytes must equal JAX's ``encode_ima_chunk`` and the host
codec's ``utils.adpcm.encode_ima`` exactly.  The renderer tests use a
graph whose f32 render is bit-exact between the packages (a sampler at
rate 1 through a settled volume), so that the pcm16 fed to the two
encoders is the same and the shipped rows are byte-equal on both
lowerings.
"""

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.sample_resource import SampleResource as JaxResource
from firewheel_tpu.ops import adpcm_device as jad
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.ops import adpcm_device as tad
from firewheel_tpu_torch.utils import adpcm

SR, F = 48000, 128
CLIP = (np.random.default_rng(5).standard_normal((2, 4096)) * 0.3).astype(np.float32)


def _pcm(rng, b, s, no):
    """Seeded int16 frames with full-scale edges and steps (the step index
    saturates at both ends of its table)."""
    x = (rng.standard_normal((b, s, no)) * 6000).clip(-32768, 32767).astype(np.int16)
    x[0, : s // 2] = -32768
    x[0, s // 2:] = 32767
    if b > 1:
        x[1, ::5] = 0
    return x


@pytest.mark.parametrize("no", [1, 2])
@pytest.mark.parametrize("frames", [8, 136, 512])
def test_encode_equals_jax_and_host_codec(no, frames):
    x = _pcm(np.random.default_rng(frames + no), 4, frames, no)
    got = tad.encode_ima_chunk(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    assert got.shape == (4, tad.chunk_block_align(no, frames))
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jad.encode_ima_chunk(x)))
    for b in range(4):
        payload, _ = adpcm.encode_ima(x[b].T, tad.chunk_block_align(no, frames))
        np.testing.assert_array_equal(got[b], np.frombuffer(payload, np.uint8))


@pytest.mark.parametrize("frames", [7, 12, 0])
def test_encode_refuses_frames_not_divisible_by_8(frames):
    with pytest.raises(ValueError, match="divide by 8"):
        tad.encode_ima_chunk(torch.zeros((1, frames, 2), dtype=torch.int16))
    if frames:
        with pytest.raises(ValueError, match="divide by 8"):
            tad.chunk_block_align(2, frames)


def test_encode_refuses_other_dtypes_and_ranks():
    with pytest.raises(TypeError):
        tad.encode_ima_chunk(torch.zeros((1, 8, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tad.encode_ima_chunk(torch.zeros((8, 2), dtype=torch.int16))


def test_decode_round_trip():
    """Decoding the rows gives the host decoder's samples; the first frame
    of each channel is exact (it is the header's predictor) and a slow sine
    comes back within the codec's step."""
    t = np.arange(512) / SR
    sig = np.stack([np.sin(2 * np.pi * 440 * t), 0.5 * np.sin(2 * np.pi * 97 * t)])
    x = np.round(sig.T[None] * 12000).astype(np.int16)  # [1, 512, 2]
    rows = tad.encode_ima_chunk(torch.from_numpy(x)).numpy()
    dec = tad.decode_ima_chunk(rows, 2, 512)
    assert dec.shape == (1, 2, 512)
    np.testing.assert_array_equal(dec, jad.decode_ima_chunk(rows, 2, 512))
    np.testing.assert_array_equal(dec[0, :, 0], x[0, 0])
    err = np.abs(dec[0].T.astype(np.int32) - x[0].astype(np.int32))
    assert err[64:].max() < 600, err.max()


def sampler_program(pkg):
    """A seeded stereo clip on a linear sampler at rate 1 through a volume of
    70% (its smoother settled): the same f32 bits in both packages."""
    mod, nodes = (fw, jn) if pkg == "jax" else (ft, tn)
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    sn = nodes.SamplerNode(percent_volume=100.0, quality="linear")
    sn.set_sample(JaxResource(CLIP, device=False) if pkg == "jax"
                  else ft.SampleResource(CLIP))
    sn.play()
    s = g.add_node(0, 2, sn)
    v = g.add_node(2, 2, nodes.VolumeNode(70.0))
    for ch in range(2):
        g.connect(s, ch, v, ch)
        g.connect(v, ch, g.graph_out_node(), ch)
    pk = g.compile(SR, F)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)


def _seek(params, positions):
    """Each instance's sampler starts at its own frame (the stacked params
    of either package, as numpy or tensors)."""
    for p in params.values():
        if isinstance(p, dict) and "seek_pos" in p:
            if isinstance(p["seek_pos"], torch.Tensor):
                p["seek_pos"].copy_(torch.as_tensor(positions))
            else:
                p["seek_pos"] = np.asarray(positions, np.asarray(p["seek_pos"]).dtype)
    return params


@pytest.mark.parametrize("lowering", ["xla", "hybrid"])
def test_batch_renderer_adpcm4_equals_jax(lowering):
    """Three chunks of K=4 (S=512 frames) at B=2 with per-instance seek
    positions: the port's rows equal JAX's byte for byte, equal the encode
    of the port's own pcm16 render, and are a quarter of pcm16's bytes
    plus the headers."""
    b, k = 2, 4
    jkw = {"lowering": lowering}
    if lowering == "hybrid":
        jkw.update(hybrid_interpret=True, tile=b)
    jbr = JaxBatchRenderer(sampler_program("jax"), b, output_format="adpcm4", **jkw)
    tprog = sampler_program("port")
    tbr = ft.BatchRenderer(tprog, b, device="cpu", output_format="adpcm4",
                           lowering=lowering)
    pcm = ft.BatchRenderer(tprog, b, device="cpu", output_format="pcm16",
                           lowering=lowering)
    seeks = [0, 1000]
    jp = _seek(jax.tree.map(np.asarray, jbr.stack_params()), seeks)
    tp = _seek(tbr.stack_params(), seeks)
    js, ts, ps = jbr.init_state(), tbr.init_state(), pcm.init_state()
    for c in range(3):
        start = c * k * F
        jo, _, js = jbr.render_chunk(jp, js, start_sample=start, num_blocks=k)
        to, tm, ts = tbr.render_chunk(tp, ts, start_sample=start, num_blocks=k)
        po, _, ps = pcm.render_chunk(tp, ps, start_sample=start, num_blocks=k)
        assert to.dtype == torch.uint8 and to.shape == (b, tad.chunk_block_align(2, k * F))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=f"chunk {c}")
        wire = po.reshape(b, k * F, 2)
        np.testing.assert_array_equal(to, tad.encode_ima_chunk(wire))
        assert to.numel() == wire.numel() * wire.element_size() // 4 + b * 2 * 4
        assert tm.shape == (b, k, 2)
    assert np.abs(po.numpy()).max() > 1000


def test_adpcm4_needs_frames_divisible_by_8():
    """In blocks of 100 frames, K=1 (100 frames) is refused before a render;
    K=2 (200) ships."""
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, tn.BeepTestNode(440.0, -12.0, True))
    g.connect(beep, 0, g.graph_out_node(), 0)
    g.connect(beep, 1, g.graph_out_node(), 1)
    pk = g.compile(SR, 100)
    prog = ft.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR,
                              device="cpu")
    br = ft.BatchRenderer(prog, 1, device="cpu", output_format="adpcm4")
    with pytest.raises(ValueError, match="divisible by 8"):
        br.render_chunk(br.stack_params(), br.init_state(), num_blocks=1)
    out, _, _ = br.render_chunk(br.stack_params(), br.init_state(), num_blocks=2)
    assert out.shape == (1, tad.chunk_block_align(2, 200))


def test_render_stream_ships_adpcm4_rows():
    """render_stream's chunks (two egress buffers sized for uint8[B,
    block_align]) equal render_chunk's, in order."""
    prog = sampler_program("port")
    br = ft.BatchRenderer(prog, 3, device="cpu", output_format="adpcm4")
    params = _seek(br.stack_params(), [0, 7, 2048])
    seq, st = [], br.init_state()
    for c in range(3):
        out, _, st = br.render_chunk(params, st, start_sample=c * 4 * F, num_blocks=4)
        seq.append(out.numpy().copy())
    streamed, _, nxt = br.render_stream(params, br.init_state(), num_chunks=3,
                                        num_blocks=4)
    assert nxt == 3 * 4 * F
    for a, b in zip(seq, streamed, strict=True):
        assert b.dtype == np.uint8 and b.shape == (3, tad.chunk_block_align(2, 512))
        np.testing.assert_array_equal(a, b)


def serve(pkg):
    """A SessionServer over the sampler graph, adpcm4, capacity 3, two
    sessions; three chunks through render_fetched and a flush."""
    mod = fw if pkg == "jax" else ft
    kw = {} if pkg == "jax" else {"device": "cpu"}
    srv = mod.SessionServer(sampler_program(pkg), capacity=3, chunk_blocks=4,
                            output_format="adpcm4", **kw)
    slots = [srv.connect().slot, srv.connect().slot]
    rows = [srv.render_fetched() for _ in range(3)]
    rows.append(srv.flush())
    return slots, rows


def test_session_server_ships_adpcm4_rows():
    """render_fetched ships one IMA block per slot a chunk (chunk t−1 while
    t renders): the port's rows equal JAX's server's byte for byte, and a
    session's row decodes to its slot's audio."""
    (jslots, jrows), (tslots, trows) = serve("jax"), serve("port")
    assert jslots == tslots
    assert jrows[0] is None and trows[0] is None
    for j, t in zip(jrows[1:], trows[1:], strict=True):
        assert t.dtype == np.uint8 and t.shape == (3, tad.chunk_block_align(2, 512))
        np.testing.assert_array_equal(t, np.asarray(j))
    dec = tad.decode_ima_chunk(trows[1], 2, 512)
    assert np.abs(dec[tslots[0]].astype(np.int32)).max() > 1000


def test_quantize_by_count_equals_the_successive_approximation():
    """K4's quantizer (``quantize_by_count``: the first bit, then the count
    of the thresholds the remainder reaches and the largest of them)
    against the successive approximation of ``encode_ima_chunk_reference``'s
    step (its lines below): ``mag`` and ``dq`` equal for every step index
    0..88 and every ``diff`` in -65535..65535, all that an int16 target and
    a clamped predictor can make (11.7 M cases)."""
    table = torch.as_tensor(adpcm.IMA_STEP_TABLE, dtype=torch.int64)
    ad = torch.arange(-65535, 65536, dtype=torch.int64).abs()
    for idx in range(89):
        step = table[idx].expand_as(ad)
        half, quarter, eighth = step >> 1, step >> 2, step >> 3
        b4 = (ad >= step).to(torch.int64)
        rest = ad - b4 * step
        b2 = (rest >= half).to(torch.int64)
        rest = rest - b2 * half
        b1 = (rest >= quarter).to(torch.int64)
        mag, dq = tad.quantize_by_count(ad, step)
        assert torch.equal(mag, b4 * 4 + b2 * 2 + b1), idx
        assert torch.equal(dq, eighth + b1 * quarter + b2 * half + b4 * step), idx
