"""The port's world-space spatial scene (``firewheel_tpu_torch/scene3d.py``):
``tests/test_scene3d.py`` on the port's ``AudioListener``/``SpatialScene``
and spatial nodes, and both packages pushing the same listener-frame
positions for the same poses and moves (the module is copied, so exactly
the same floats)."""

import numpy as np
import pytest

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import nodes as tn


def test_identity_pose_is_passthrough():
    lis = ft.AudioListener()
    assert np.allclose(lis.to_listener_frame((1.0, 2.0, -3.0)), (1.0, 2.0, -3.0))


def test_rotated_listener():
    # facing +x: (5, 0, 0) is straight ahead; (0, 0, -5) is to the left
    lis = ft.AudioListener(forward=(1.0, 0.0, 0.0))
    assert np.allclose(lis.to_listener_frame((5.0, 0.0, 0.0)), (0, 0, -5))
    x, y, z = lis.to_listener_frame((0.0, 0.0, -5.0))
    assert x < -4.9 and abs(y) < 1e-9 and abs(z) < 1e-9


def test_translated_listener():
    lis = ft.AudioListener(position=(10.0, 0.0, 0.0))
    assert np.allclose(lis.to_listener_frame((10.0, 1.0, -2.0)), (0, 1, -2))


def test_up_reorthogonalized():
    lis = ft.AudioListener(forward=(0, 0, -1), up=(0.2, 1.0, -0.3))
    f = lis.to_listener_frame
    m = np.stack([np.array(f(v)) for v in ((1, 0, 0), (0, 1, 0), (0, 0, -1))])
    assert np.allclose(m @ m.T, np.eye(3), atol=1e-9)


@pytest.mark.parametrize("node_cls", [tn.Spatializer3DNode,
                                      tn.BinauralSpatializerNode])
def test_scene_pushes_node_positions(node_cls):
    scene = ft.SpatialScene()
    sp = node_cls()
    scene.add("e", sp, world_pos=(3.0, 0.0, -4.0))
    assert np.allclose(sp.position(), (3.0, 0.0, -4.0))
    # the listener turns to face the emitter: dead ahead at range 5
    scene.set_listener(forward=(3.0, 0.0, -4.0))
    x, y, z = sp.position()
    assert abs(x) < 1e-9 and abs(y) < 1e-9 and abs(z + 5.0) < 1e-9
    scene.move("e", (0.0, 2.0, 0.0))
    assert abs(sp.position()[1] - 2.0) < 1e-9
    scene.remove("e")
    with pytest.raises(KeyError):
        scene.move("e", (0, 0, 0))


def test_degenerate_up_parallel_forward():
    lis = ft.AudioListener(forward=(0, 1, 0), up=(0, 1, 0))
    x, y, z = lis.to_listener_frame((0.0, 5.0, 0.0))
    assert abs(z + 5.0) < 1e-9


def test_scene_rejects_a_node_without_set_position():
    with pytest.raises(TypeError, match="set_position"):
        ft.SpatialScene().add("e", tn.SumNode(), (0.0, 0.0, 0.0))


def test_both_packages_push_the_same_positions():
    """Eight emitters and a listener that moves, turns and rolls: after each
    step every node of the port's scene holds exactly the position the
    JAX package's scene pushed into its twin."""
    rng = np.random.default_rng(11)
    scenes = (fw.SpatialScene(), ft.SpatialScene())
    kinds = ((jn.Spatializer3DNode, tn.Spatializer3DNode),
             (jn.BinauralSpatializerNode, tn.BinauralSpatializerNode))
    pairs = []
    for i in range(8):
        world = tuple(rng.uniform(-10.0, 10.0, 3))
        pair = tuple(cls() for cls in kinds[i % 2])
        for scene, node in zip(scenes, pair):
            scene.add(i, node, world)
        pairs.append(pair)
    steps = [
        lambda s: s.set_listener(position=(1.0, 0.5, -2.0)),
        lambda s: s.set_listener(forward=(0.3, 0.1, -1.0), up=(0.1, 1.0, 0.0)),
        lambda s: s.move(3, (4.0, -1.0, 2.5)),
        lambda s: s.set_listener(forward=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0)),
        lambda s: s.remove(5),
        lambda s: s.set_listener(position=(-3.0, 0.0, 7.0), forward=(-1.0, 0.0, 0.0)),
    ]
    for step in steps:
        for scene in scenes:
            step(scene)
        for jnode, tnode in pairs:
            assert tnode.position() == jnode.position()
    assert len({p[1].position() for p in pairs}) == 8
