"""Fly-camera controller (txr/scene/camera.py).

Pure Python state after the reference's GLFW FPS camera
(SceneManager.cpp:43-135): yaw/pitch mouse look (sensitivity 0.05, pitch
clamped to ±89°), WASD/space/ctrl movement at 3 units/s (×3 with shift,
÷6 with alt), camera quaternion from the euler angles (−pitch, yaw, 0).
Callers feed key states and mouse deltas from whatever front end they
have; the demo app scripts them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from txr_torch.geometry import quaternion as quat


@dataclasses.dataclass
class FlyCamera:
    position: tuple = (0.0, 0.0, 0.0)
    yaw: float = 0.0     # degrees, like the reference
    pitch: float = 0.0
    world_up: tuple = (0.0, 1.0, 0.0)
    sensitivity: float = 0.05           # SceneManager.cpp:124
    speed: float = 3.0                  # SceneManager.cpp:52
    # key states (SceneManager.cpp:76-101)
    w: bool = False
    a: bool = False
    s: bool = False
    d: bool = False
    space: bool = False
    ctrl: bool = False
    shift: bool = False
    alt: bool = False

    def mouse(self, dx, dy):
        """Mouse look; dy positive looks up (SceneManager.cpp:110-135)."""
        self.yaw += dx * self.sensitivity
        self.pitch += dy * self.sensitivity
        self.pitch = max(-89.0, min(89.0, self.pitch))

    def key(self, name, pressed=True):
        setattr(self, name, pressed)

    def _front_right(self):
        ry, rp = math.radians(self.yaw), math.radians(self.pitch)
        fx, fy, fz = (math.sin(ry) * math.cos(rp), math.sin(rp), math.cos(ry) * math.cos(rp))
        # right = normalize(cross(-front, world_up)) (SceneManager.cpp:49)
        ux, uy, uz = self.world_up
        rx, ry_, rz = -fy * uz + fz * uy, -fz * ux + fx * uz, -fx * uy + fy * ux
        n = math.sqrt(rx * rx + ry_ * ry_ + rz * rz) or 1.0
        return (fx, fy, fz), (rx / n, ry_ / n, rz / n)

    def update(self, dt):
        """Integrate one frame (SceneManager::update_scene, :43-74)."""
        front, right = self._front_right()
        speed = dt * self.speed
        if self.shift:
            speed *= 3.0
        if self.alt:
            speed /= 6.0
        p = tuple(self.position)
        for on, v, s in ((self.w, front, speed), (self.s, front, -speed),
                         (self.a, right, -speed), (self.d, right, speed),
                         (self.space, self.world_up, speed), (self.ctrl, self.world_up, -speed)):
            if on:
                p = (p[0] + v[0] * s, p[1] + v[1] * s, p[2] + v[2] * s)
        self.position = p

    @property
    def quat(self):
        """Camera rotation: glm::quat(vec3(−pitch, yaw, 0)) in radians
        (SceneManager.cpp:50), float32 [4] on the CPU."""
        return quat.from_euler([-math.radians(self.pitch), math.radians(self.yaw), 0.0])

    @property
    def pos(self):
        return torch.tensor(self.position, dtype=torch.float32)

    def apply(self, scene):
        """The scene with this camera pose written in, as tensors on the
        scene's device."""
        dev = scene.device
        return dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, pos=self.pos.to(dev), quat=self.quat.to(dev)))
