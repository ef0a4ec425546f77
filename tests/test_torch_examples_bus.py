"""The port's mastering-bus example (``firewheel_tpu_torch.examples.
mastering_bus``) on the CPU beside the JAX package's (``examples/
mastering_bus.py``, loaded from its file), on the same inputs: the bus
streamed in 256-frame buffers, the dialogue toggled by stream time, the
loudness meter polled every 100 ms into the R128 gate.

Cut on both sides to 1.2 s (the port's ``SECS``, JAX's ``activate``
duration; the example streams 4 s, which the port's plain sample scans
take over a minute for here; 4 s runs on the card in ``chip_smoke.py``):
the dialogue comes on at 1.0 s and the meter is read 12 times.  Each
``update()`` lands on the same frame count in both packages; the WAVs
within 1e-6; each reading (momentary, short-term, gating block), the
integrated and the final short-term loudness within 1e-3 LU, the JAX
meter's K-weighting scan run op by op as the port's plain scan runs it
(under jit, XLA's fused multiply-adds in the scan, amplified by the 38 Hz
high-pass's pole, move the readings by up to 1.8e-3 LU over 1.2 s:
``test_torch_mastering.py``).
"""

import numpy as np

import firewheel_tpu_torch as ft
from firewheel_tpu_torch.examples import mastering_bus
from test_torch_examples import TOL, _load_jax_example
from test_torch_examples_stream import _frames_per_update, unfused_jax_scan

SECS = 1.2
LU_TOL = 1e-3


def test_mastering_bus_matches_jax(monkeypatch, tmp_path, capsys):
    from firewheel_tpu.nodes import loudness as jax_loudness

    unfused_jax_scan(monkeypatch, jax_loudness)
    jax_wav, port_wav = tmp_path / "jax.wav", tmp_path / "port.wav"
    monkeypatch.setattr("sys.argv", ["mastering_bus.py", str(jax_wav)])
    jax_mod = _load_jax_example("mastering_bus")
    jax_frames, port_frames, jax_reads = [], [], []
    read = jax_mod.LoudnessMeterNode.read

    class Meter(jax_mod.LoudnessMeterNode):
        @staticmethod
        def read(state):
            r = read(state)
            jax_reads.append((r["momentary_lufs"], r["short_term_lufs"],
                              r["gating_block_lufs"]))
            return r

    integrated = []

    class Gate(jax_mod.IntegratedLoudness):
        def value(self):
            integrated.append(super().value())
            return integrated[-1]

    class Ctx(_frames_per_update(jax_mod.FirewheelCtx, jax_frames)):
        def activate(self, *a, duration_secs=None, **kw):
            return super().activate(*a, duration_secs=SECS, **kw)

    monkeypatch.setattr(jax_mod, "LoudnessMeterNode", Meter)
    monkeypatch.setattr(jax_mod, "IntegratedLoudness", Gate)
    monkeypatch.setattr(jax_mod, "FirewheelCtx", Ctx)
    monkeypatch.setattr(mastering_bus, "SECS", SECS)
    monkeypatch.setattr(mastering_bus, "FirewheelCtx",
                        _frames_per_update(mastering_bus.FirewheelCtx, port_frames))
    jax_mod.main()
    printed = capsys.readouterr().out
    got = mastering_bus.main(str(port_wav), device="cpu")
    mine = capsys.readouterr().out

    assert port_frames == jax_frames and jax_frames[-1] == int(SECS * 48000)
    want = ft.load_audio(str(jax_wav), device=False)[0].host_data
    have = ft.load_audio(str(port_wav), device=False)[0].host_data
    assert have.shape == want.shape == (2, int(SECS * 48000))
    np.testing.assert_allclose(have, want, atol=TOL, rtol=0)
    # the dialogue came on: the last 100 ms carry the 280 Hz line
    spec = np.abs(np.fft.rfft(have[0, -4800:]))
    assert np.argmax(spec[1:]) + 1 == 28

    reads, want_reads = np.asarray(got["reads"]), np.asarray(jax_reads[:-1])
    assert reads.shape == want_reads.shape == (12, 3)
    finite = np.isfinite(want_reads)
    assert (np.isfinite(reads) == finite).all() and finite[-1].all()
    np.testing.assert_allclose(reads[finite], want_reads[finite], atol=LU_TOL, rtol=0)
    assert abs(got["short_term"] - jax_reads[-1][1]) <= LU_TOL
    assert abs(got["integrated"] - integrated[-1]) <= LU_TOL
    assert np.isfinite(got["integrated"]) and -30.0 < got["integrated"] < -5.0
    assert mine.replace(str(port_wav), str(jax_wav)).splitlines()[:-3] == \
        printed.splitlines()[:-3]
