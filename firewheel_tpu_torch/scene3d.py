"""World-space spatial scene: a listener pose + emitters in world
coordinates.

The spatial nodes (:class:`~firewheel_tpu_torch.nodes.spatial.Spatializer3DNode`,
:class:`~firewheel_tpu_torch.nodes.binaural.BinauralSpatializerNode`) take positions in
the LISTENER frame (+x right, +y up, −z forward) — the DSP-correct
contract, but games track everything in world space with a moving,
rotating listener (the camera/player).  This module is the thin
world→listener bridge every engine ships:

* :class:`AudioListener` — a world-space pose (position, forward, up)
  and the change-of-basis into the listener frame;
* :class:`SpatialScene` — attach any node with ``set_position`` at a
  world position; moving an emitter or the listener re-derives and
  pushes the relative coordinates of everything affected.  Positions are
  live params (the nodes' smoothers de-zipper them), so per-frame
  listener motion costs a few host-side dot products and zero
  recompiles.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AudioListener", "SpatialScene"]


def _normalize(v):
    v = np.asarray(v, np.float64)
    n = np.linalg.norm(v)
    if n < 1e-12:
        raise ValueError("zero-length direction vector")
    return v / n


class AudioListener:
    """World-space listener pose and the world→listener transform.

    ``forward``/``up`` are world-space directions (need not be exactly
    orthogonal — ``up`` is re-orthogonalized against ``forward``)."""

    def __init__(self, position=(0.0, 0.0, 0.0), forward=(0.0, 0.0, -1.0),
                 up=(0.0, 1.0, 0.0)):
        self.set_pose(position, forward, up)

    def set_pose(self, position=None, forward=None, up=None):
        if position is not None:
            self.position = np.asarray(position, np.float64)
        if forward is not None:
            self._forward = _normalize(forward)
        if up is not None:
            self._up_hint = _normalize(up)
        f = self._forward
        r = np.cross(f, self._up_hint)
        if np.linalg.norm(r) < 1e-9:
            # forward parallel to up: pick any perpendicular right vector
            r = np.cross(f, (1.0, 0.0, 0.0))
            if np.linalg.norm(r) < 1e-9:
                r = np.cross(f, (0.0, 1.0, 0.0))
        self._right = _normalize(r)
        self._up = np.cross(self._right, f)

    def to_listener_frame(self, world_pos):
        """World position → listener-frame ``(x right, y up, z −forward)``
        — what the spatializer/binaural nodes consume."""
        rel = np.asarray(world_pos, np.float64) - self.position
        return (
            float(rel @ self._right),
            float(rel @ self._up),
            float(-(rel @ self._forward)),
        )


class SpatialScene:
    """Emitters in world space around a moving listener::

        scene = SpatialScene()
        sp = Spatializer3DNode(doppler=True)
        nid = g.add_node(1, 2, sp)
        scene.add("engine", sp, world_pos=(10, 0, 3))
        ...
        scene.move("engine", car.position)           # per frame
        scene.set_listener(cam.pos, cam.forward, cam.up)

    Any object with ``set_position((x, y, z))`` attaches (both built-in
    spatial nodes qualify).  Every mutation immediately pushes the new
    listener-frame coordinates into the affected nodes — live params,
    zero recompiles."""

    def __init__(self, listener: AudioListener | None = None):
        self.listener = listener or AudioListener()
        self._emitters: dict = {}  # key -> (node, world_pos)

    def add(self, key, node, world_pos) -> None:
        if not hasattr(node, "set_position"):  # real error: asserts vanish under -O
            raise TypeError(
                f"emitter node {node!r} has no set_position() — pass a "
                "Spatializer3DNode/BinauralSpatializerNode (or any node "
                "with the positional-emitter protocol)"
            )
        self._emitters[key] = (node, np.asarray(world_pos, np.float64))
        self._push(key)

    def remove(self, key) -> None:
        self._emitters.pop(key, None)

    def move(self, key, world_pos) -> None:
        node, _ = self._emitters[key]
        self._emitters[key] = (node, np.asarray(world_pos, np.float64))
        self._push(key)

    def world_position(self, key):
        return tuple(self._emitters[key][1])

    def set_listener(self, position=None, forward=None, up=None) -> None:
        """Move/rotate the listener; every emitter's relative position is
        re-derived and pushed."""
        self.listener.set_pose(position, forward, up)
        for key in self._emitters:
            self._push(key)

    def _push(self, key) -> None:
        node, world = self._emitters[key]
        node.set_position(self.listener.to_listener_frame(world))
