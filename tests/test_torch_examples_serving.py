"""The port's session-server example (``firewheel_tpu_torch.examples.
session_server``) on the CPU beside the JAX package's (``examples/
session_server.py``, loaded from its file): 16 slots over one program, SFX
completion events, a live mute, a disconnect and a newcomer.  Every chunk
the server rendered within 1e-6 as f32, or within 1 LSB as the wire's
pcm16 (the JAX example's server built with ``output_format="pcm16"`` too),
and the printed lines equal.
"""

import numpy as np
import pytest

from firewheel_tpu_torch.examples import session_server
from test_torch_examples import TOL, _load_jax_example


def _recording_server(cls, log, **forced):
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, **forced})

        def render(self, *a, **kw):
            out = super().render(*a, **kw)
            log.append(np.array(out.cpu() if hasattr(out, "cpu") else out))
            return out

    return Recording


@pytest.mark.parametrize("output_format", ["f32", "pcm16"])
def test_session_server_matches_jax(output_format, monkeypatch, capsys):
    jax_mod = _load_jax_example("session_server")
    jax_chunks, port_chunks = [], []
    forced = {} if output_format == "f32" else {"output_format": "pcm16"}
    monkeypatch.setattr(jax_mod, "SessionServer",
                        _recording_server(jax_mod.SessionServer, jax_chunks, **forced))
    monkeypatch.setattr(session_server, "SessionServer",
                        _recording_server(session_server.SessionServer, port_chunks))
    jax_mod.main()
    printed = capsys.readouterr().out
    got = session_server.main(output_format, device="cpu")
    assert capsys.readouterr().out == printed
    assert len(port_chunks) == len(jax_chunks) == 9
    for c, (a, b) in enumerate(zip(port_chunks, jax_chunks)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if output_format == "pcm16":
            assert a.dtype == np.int16
            assert np.abs(a.astype(np.int32) - b).max() <= 1, f"chunk {c}"
        else:
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=f"chunk {c}")
    np.testing.assert_array_equal(got["last_chunk"], port_chunks[-1])
    assert got["fired"] == [0, 2, 4, 6]
    assert got["rms"][3] == 0 and got["rms"][5] > 0.05 and not got["rms"][8:].any()
    assert got["session_seconds"] == pytest.approx(8 * 9 * 16 * 128 / 48000)
