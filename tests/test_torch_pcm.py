"""pcm16 egress in the port: ``core.sample_resource.pcm_f32_to_i16`` and
``BatchRenderer(output_format="pcm16")``, held against the JAX package.

The quantizer is the exact inverse of the reference's i16→f32 load formula
(sample_resource.rs:338-340): equal to JAX's on every value here.  A pcm16
render is the f32 render quantized, bit for bit within the port, on both
lowerings; against JAX's pcm16 it is equal, or 1 LSB apart where the two
f32 renders differ by an ulp across a rounding boundary (counted).
"""

import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.sample_resource import pcm_f32_to_i16 as jax_pcm
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.core.sample_resource import pcm_f32_to_i16, pcm_i16_to_f32

SR, F = 48000, 128


def test_roundtrip_full_i16_range():
    """Every value pcm_i16_to_f32 can produce quantizes back exactly."""
    i = np.arange(-32767, 32768, dtype=np.int16)
    back = pcm_f32_to_i16(torch.from_numpy(pcm_i16_to_f32(i))).numpy()
    np.testing.assert_array_equal(back, i)
    np.testing.assert_array_equal(np.asarray(jax_pcm(pcm_i16_to_f32(i))), i)


def test_clip_and_edge_values_equal_jax():
    """Clipping, ±1, ±inf, ties at half an LSB (rounded half to even on
    both sides) and a seeded spread over [-1.5, 1.5]: equal to JAX's."""
    half = ((np.arange(-32767, 32767) + 0.5) / 32767).astype(np.float32)
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.array([-2.0, -1.0, -1.0 + 1e-8, 0.0, -0.0, 1.0, 2.0, 0.5,
                  np.inf, -np.inf, 1.0 / 65534, -1.0 / 65534], np.float32),
        half,
        rng.uniform(-1.5, 1.5, 100_000).astype(np.float32),
    ])
    got = pcm_f32_to_i16(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, np.asarray(jax_pcm(x)))
    assert got[0] == -32767 and got[1] == -32767 and got[3] == 0
    assert got[5] == 32767 and got[6] == 32767 and got[8] == 32767
    assert got[7] == int(np.round(0.5 * 32767))


def beep_program(pkg):
    mod, nodes = (fw, jn) if pkg == "jax" else (ft, tn)
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    vol = g.add_node(2, 2, nodes.VolumeNode(100.0))
    for ch in range(2):
        g.connect(beep, ch, vol, ch)
        g.connect(vol, ch, g.graph_out_node(), ch)
    pk = g.compile(SR, F)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)


@pytest.mark.parametrize("lowering", ["xla", "hybrid"])
def test_pcm16_matches_f32_render(lowering):
    """Two chunks of B=4, K=3: the port's pcm16 render is its f32 render
    quantized and interleaved ``int16[B, K, F, No]`` (masks and state equal),
    and within 1 LSB of JAX's pcm16 on the same lowering."""
    B, K = 4, 3
    prog = beep_program("port")
    f32 = ft.BatchRenderer(prog, B, device="cpu", lowering=lowering)
    p16 = ft.BatchRenderer(prog, B, device="cpu", lowering=lowering,
                           output_format="pcm16")
    jprog = beep_program("jax")
    kw = {"tile": 4, "hybrid_interpret": True} if lowering == "hybrid" else {}
    jax16 = JaxBatchRenderer(jprog, batch=B, lowering=lowering,
                             output_format="pcm16", **kw)
    sf, s16, js = f32.init_state(), p16.init_state(), jax16.init_state()
    off = 0
    for c in range(2):
        out_f, mask_f, sf = f32.render_chunk(f32.stack_params(), sf,
                                             start_sample=c * K * F, num_blocks=K)
        out_i, mask_i, s16 = p16.render_chunk(p16.stack_params(), s16,
                                              start_sample=c * K * F, num_blocks=K)
        out_j, mask_j, js = jax16.render_chunk(jax16.stack_params(), js,
                                               start_sample=c * K * F, num_blocks=K)
        assert out_i.dtype == torch.int16 and out_i.is_contiguous()
        assert tuple(out_i.shape) == (B, K, F, prog.num_graph_outputs)
        expect = pcm_f32_to_i16(out_f.transpose(-1, -2))
        assert torch.equal(out_i, expect) and torch.equal(mask_i, mask_f)
        np.testing.assert_array_equal(mask_i.numpy(), np.asarray(mask_j))
        d = np.abs(out_i.numpy().astype(np.int32) - np.asarray(out_j).astype(np.int32))
        assert d.max() <= 1
        off += int((d == 1).sum())
    assert np.abs(out_i.numpy().astype(np.int32)).max() > 8000
    assert off <= 8, f"{off} samples 1 LSB apart"
