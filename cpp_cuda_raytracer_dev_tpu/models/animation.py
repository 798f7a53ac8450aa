"""Keyboard-semantics animation: scripted pose updates per tick.

The reference's interactivity is a 30 Hz input tick inside the frame loop
(``WinMain.cpp:174-239``): held keys stage a quaternion/translation into
``Input`` (Input.cpp:6-19) and apply it to the object pose through
``transform_camera_voxel_device_memory`` (Camera.cu:254-330). A headless
renderer has no Win32 message pump, so the equivalent is a *key script*: a sequence of
(key, ticks) pairs replayed by the offline driver (apps/animate.py), each
tick performing the same O(1) pose update — the pose is a tiny pytree fed to
the jitted frame function, geometry never re-uploads.

Key bindings (WinMain.cpp:186-209):
  W/S  translate the object along the camera view axis n by ±cam_speed
  Q/E  strafe along the camera right axis u by ±cam_speed
  R/T  yaw the object about +y/-y by the fixed key quaternion
       (0, 0.0995..., 0, 0.9950...), pivoting about the object itself
       (the recentering dance at Camera.cu:288-329)
  ESC  stop

Divergence note: the reference mutates the pose *matrix* in place and has a
row-swap bug in one quat->matrix path (Quaternion.cpp:51-67); we use clean
quaternion algebra (ops/quaternion.py) with identical capability.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..ops import quaternion
from .camera import Camera
from .scene import Scene

CAM_SPEED = 0.005          # WinMain.cpp:171
KEY_QUAT_SIN = 0.09950371902099893   # WinMain.cpp:187
KEY_QUAT_COS = 0.9950371902099893


@dataclasses.dataclass(frozen=True)
class KeyEvent:
    key: str     # one of W S Q E R T
    ticks: int   # how many 30Hz ticks the key is held


def _yaw_quat(sign: float) -> jnp.ndarray:
    return jnp.array([0.0, sign * KEY_QUAT_SIN, 0.0, KEY_QUAT_COS],
                     jnp.float32)


def apply_key(scene: Scene, camera: Camera, key: str,
              obj_index: int = 0) -> Scene:
    """One tick of one held key -> new scene (pure update)."""
    obj = scene.objects[obj_index]
    n, u, _ = camera.basis()
    if key == "W":
        pose = obj.pose.translated(n * CAM_SPEED)
    elif key == "S":
        pose = obj.pose.translated(-n * CAM_SPEED)
    elif key == "Q":
        pose = obj.pose.translated(u * CAM_SPEED)
    elif key == "E":
        pose = obj.pose.translated(-u * CAM_SPEED)
    elif key in ("R", "T"):
        pivot = obj.pose.apply(obj.tris.centroid())
        dq = _yaw_quat(1.0 if key == "R" else -1.0)
        pose = obj.pose.rotated(dq, pivot=pivot)
    else:
        raise ValueError(f"unknown key {key!r}")
    objects = list(scene.objects)
    objects[obj_index] = obj.replace(pose=pose)
    return scene.replace(objects=tuple(objects))


def run_script(scene: Scene, camera: Camera, script: list[KeyEvent],
               obj_index: int = 0):
    """Yields (tick_index, key, scene) after each tick of the script."""
    tick = 0
    for ev in script:
        for _ in range(ev.ticks):
            scene = apply_key(scene, camera, ev.key, obj_index)
            yield tick, ev.key, scene
            tick += 1


def demo_script() -> list[KeyEvent]:
    """Dolly in, orbit, strafe — a deterministic showcase path."""
    return [KeyEvent("W", 30), KeyEvent("R", 20), KeyEvent("Q", 15),
            KeyEvent("T", 40), KeyEvent("E", 15), KeyEvent("S", 30),
            KeyEvent("R", 20)]
