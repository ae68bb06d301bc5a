"""Camera controllers for the interactive viewer.

Reimplements the reference's two controllers (viewer/camera.rs) as pure
numpy transforms over ``Camera.cam_to_world``:

- OrbitalCameraController (camera.rs:19-100): mouse drag orbits the eye
  around a pivot (horizontal drag about the camera's horizontal axis,
  vertical about the vertical axis), scroll zooms radially with a 0.01
  minimum radius, and the camera re-aims at the pivot (look_at).
- FirstPersonCameraController (camera.rs:102-214): WASD/space/shift
  translate in the camera frame, mouse yaw/pitch, Q/E roll (spin).

Controllers accumulate input via process_* and apply it in
``update_camera(camera, dt) -> Camera`` (the reference's
CameraControllerInterface shape), returning a NEW Camera that shares the
projection (fov/resolution) with the input.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera

_UP = np.asarray([0.0, 1.0, 0.0])


def _rotate_about(v: np.ndarray, angle: float, axis: np.ndarray):
    """Rodrigues rotation of v about (unnormalized) axis."""
    n = np.linalg.norm(axis)
    if n < 1e-12 or abs(angle) < 1e-12:
        return v
    k = axis / n
    c, s = np.cos(angle), np.sin(angle)
    return v * c + np.cross(k, v) * s + k * np.dot(k, v) * (1.0 - c)


def _look_at_c2w(eye, center, up):
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    sn = np.linalg.norm(s)
    if sn < 1e-9:  # looking straight along up: pick any right vector
        s = np.cross(f, np.asarray([1.0, 0.0, 0.0]))
        sn = np.linalg.norm(s)
    s = s / sn
    u = np.cross(s, f)
    c2w = np.eye(4)
    c2w[:3, 0] = s
    c2w[:3, 1] = u
    c2w[:3, 2] = -f  # camera looks down -z (core/camera.py convention)
    c2w[:3, 3] = eye
    return c2w


class OrbitalCameraController:
    """Orbit the eye about a pivot; re-aim at the pivot every update
    (viewer/camera.rs:62-95 math, degrees-in like process_mouse)."""

    def __init__(self, pivot, orbit_speed: float = 1.0,
                 zoom_speed: float = 1.0):
        self.pivot = np.asarray(pivot, np.float64)
        self.orbit_speed = float(orbit_speed)
        self.zoom_speed = float(zoom_speed)
        self.rotate_horizontal = 0.0
        self.rotate_vertical = 0.0
        self.scroll = 0.0

    def process_mouse(self, dx: float, dy: float):
        self.rotate_horizontal = np.radians(dx)
        self.rotate_vertical = np.radians(dy)

    def process_scroll(self, delta: float):
        self.scroll = float(delta)

    def update_camera(self, camera: Camera, dt: float) -> Camera:
        cam_pos = camera.cam_to_world[:3, 3].copy() - self.pivot
        vert_axis = np.cross(cam_pos, _UP)
        horz_axis = np.cross(cam_pos, vert_axis)
        cam_pos = _rotate_about(cam_pos,
                                self.rotate_horizontal * self.orbit_speed
                                * dt, horz_axis)
        cam_pos = _rotate_about(cam_pos,
                                self.rotate_vertical * self.orbit_speed
                                * dt, vert_axis)
        r = np.linalg.norm(cam_pos)
        # multiplicative factor clamped away from 0: the reference's
        # linear form (camera.rs:80) degenerates when scroll*speed*dt
        # <= -1 (discrete key presses use dt=1, not frame dt)
        factor = max(1.0 + self.scroll * self.zoom_speed * dt, 0.1)
        new_r = max(0.01, r * factor)
        cam_pos = cam_pos / max(r, 1e-12) * new_r
        eye = cam_pos + self.pivot
        self.rotate_horizontal = 0.0
        self.rotate_vertical = 0.0
        self.scroll = 0.0
        return dataclasses.replace(
            camera, cam_to_world=_look_at_c2w(eye, self.pivot, _UP))


class FirstPersonCameraController:
    """WASD + mouse-look first-person motion (viewer/camera.rs:102-214).

    Keys move in the CAMERA frame (w/s along -z/+z, a/d along -x/+x,
    space/shift along +y/-y world); q/e roll about the view axis."""

    def __init__(self, rotate_sensitivity: float = 1.0,
                 move_sensitivity: float = 1.0):
        self.rotate_sensitivity = float(rotate_sensitivity)
        self.move_sensitivity = float(move_sensitivity)
        self.translation = np.zeros(3)
        self.rotation = np.zeros(2)  # (yaw, pitch), radians
        self.spin = 0.0

    def process_key(self, key: str) -> bool:
        m = self.move_sensitivity
        moves = {
            "w": (2, -m), "s": (2, m),
            "a": (0, -m), "d": (0, m),
            " ": (1, m), "shift": (1, -m),
        }
        if key in moves:
            axis, amount = moves[key]
            self.translation[axis] += amount
            return True
        if key == "q":
            self.spin += self.rotate_sensitivity * 0.1
            return True
        if key == "e":
            self.spin -= self.rotate_sensitivity * 0.1
            return True
        return False

    def process_mouse(self, dx: float, dy: float):
        self.rotation[0] = np.radians(dx) * self.rotate_sensitivity
        self.rotation[1] = np.radians(dy) * self.rotate_sensitivity

    def update_camera(self, camera: Camera, dt: float) -> Camera:
        c2w = camera.cam_to_world.copy()
        rot = c2w[:3, :3]
        # translate in the camera frame
        c2w[:3, 3] = c2w[:3, 3] + rot @ self.translation
        # yaw about world up, pitch about the camera's right axis, roll
        # about the view axis
        yaw, pitch = self.rotation
        for angle, axis in ((yaw * dt, _UP), (pitch * dt, rot[:, 0]),
                            (self.spin * dt, -rot[:, 2])):
            if abs(angle) > 1e-12:
                r3 = np.stack([_rotate_about(rot[:, i], angle, axis)
                               for i in range(3)], axis=1)
                rot = r3
        c2w[:3, :3] = rot
        self.translation[:] = 0.0
        self.rotation[:] = 0.0
        self.spin = 0.0
        return dataclasses.replace(camera, cam_to_world=c2w)
