"""Perspective camera (host numpy) and batched ray generation (tensors).

Port of ``pathtracer_tpu/core/camera.py``: raster-space sample positions
(N, 2) in, world-space ray origins/directions (N, 3) out, and with
``generate_rays_diff`` the two auxiliary directions of the ray
differentials that pick the texture mip level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def perspective_matrix(aspect: float, fovy: float, znear: float,
                       zfar: float) -> np.ndarray:
    """nalgebra ``Perspective3`` projection (camera z=-znear -> NDC 0)."""
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m


def screen_to_raster_matrix(res_x: float, res_y: float) -> np.ndarray:
    """NDC [-1,1]^2 -> raster [0,res)^2, y flipped."""
    scale_res = np.diag([res_x, res_y, 1.0, 1.0])
    scale_half = np.diag([0.5, -0.5, 1.0, 1.0])
    translate = np.eye(4)
    translate[0, 3] = 1.0
    translate[1, 3] = -1.0
    return scale_res @ scale_half @ translate


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    q = m @ np.append(p, 1.0)
    return q[:3] / q[3]


@dataclasses.dataclass
class Camera:
    """Host-side camera: rigid ``cam_to_world`` and the projective
    ``raster_to_camera`` chain."""

    cam_to_world: np.ndarray  # (4,4) rigid
    raster_to_camera: np.ndarray  # (4,4) projective
    resolution: tuple[int, int]  # (width, height)
    dx_camera: np.ndarray  # (3,) camera-space shift for +1 raster x
    dy_camera: np.ndarray  # (3,)

    @staticmethod
    def create(cam_to_world: np.ndarray, aspect: float, fovy: float,
               resolution: tuple[int, int],
               znear: float = 0.01, zfar: float = 10000.0) -> "Camera":
        cam_to_screen = perspective_matrix(aspect, fovy, znear, zfar)
        raster_to_screen = np.linalg.inv(
            screen_to_raster_matrix(resolution[0], resolution[1]))
        raster_to_camera = np.linalg.inv(cam_to_screen) @ raster_to_screen
        origin = transform_point(raster_to_camera, np.zeros(3))
        dx = transform_point(raster_to_camera, np.array([1.0, 0.0, 0.0])) \
            - origin
        dy = transform_point(raster_to_camera, np.array([0.0, 1.0, 0.0])) \
            - origin
        return Camera(cam_to_world=np.asarray(cam_to_world, np.float64),
                      raster_to_camera=raster_to_camera,
                      resolution=(int(resolution[0]), int(resolution[1])),
                      dx_camera=dx, dy_camera=dy)

    @staticmethod
    def look_at(eye, center, up, fovy, resolution,
                znear: float = 0.01, zfar: float = 1000.0) -> "Camera":
        eye = np.asarray(eye, np.float64)
        f = np.asarray(center, np.float64) - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, np.asarray(up, np.float64))
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        c2w = np.eye(4)  # camera looks down -z in its own frame
        c2w[:3, 0] = s
        c2w[:3, 1] = u
        c2w[:3, 2] = -f
        c2w[:3, 3] = eye
        aspect = resolution[0] / resolution[1]
        return Camera.create(c2w, aspect, fovy, resolution, znear, zfar)

    def ray_params(self, device):
        """(raster_to_camera (4,4), cam_rot (3,3), cam_pos (3,)) float32
        tensors consumed by generate_rays."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return (t(self.raster_to_camera), t(self.cam_to_world[:3, :3]),
                t(self.cam_to_world[:3, 3]))

    def diff_params(self, device) -> torch.Tensor:
        """(2, 3) float32 camera-space offsets of a +1 raster x and y step
        (dx_camera, dy_camera), consumed by generate_rays_diff."""
        return torch.as_tensor(
            np.stack([self.dx_camera, self.dy_camera]).astype(np.float32),
            device=device)


def _camera_points_and_dirs(raster_to_camera, cam_rot, p_film):
    """Camera-space image-plane points of ``p_film`` (..., 2) and the
    normalised world-space directions through them."""
    x, y = p_film[..., 0], p_film[..., 1]
    ph = torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)], dim=-1)
    pc = ph @ raster_to_camera.T
    p_camera = pc[..., :3] / pc[..., 3:4]
    # vector_norm rounds as the reference's jnp.linalg.norm does on the
    # CPU (a sqrt of the plain 3-term dot differs in the last bit)
    d_cam = p_camera / torch.linalg.vector_norm(p_camera, dim=-1,
                                                keepdim=True)
    d_world = d_cam @ cam_rot.T
    d_world = d_world / torch.linalg.vector_norm(d_world, dim=-1,
                                                 keepdim=True)
    return p_camera, d_world


def generate_rays(raster_to_camera, cam_rot, cam_pos, p_film):
    """Batched pinhole raygen.

    p_film: (..., 2) raster-space sample positions. Returns (origins
    (..., 3), directions (..., 3) normalized, world space).
    """
    _, d_world = _camera_points_and_dirs(raster_to_camera, cam_rot, p_film)
    return cam_pos.expand(d_world.shape), d_world


def generate_rays_diff(raster_to_camera, cam_rot, cam_pos, p_film, dxdy_cam,
                       diff_scale: float):
    """Pinhole raygen with ray differentials.

    dxdy_cam: (2, 3) camera-space offsets of a +1 raster x / y step
    (Camera.diff_params); diff_scale: 1/sqrt(spp), the differentials'
    scale. The auxiliary rays share the main origin, so returns (origins,
    directions, x-step directions, y-step directions), each (..., 3).
    """
    p_camera, d_world = _camera_points_and_dirs(raster_to_camera, cam_rot,
                                                p_film)

    def aux(dcam):
        v = p_camera + dcam
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = v @ cam_rot.T
        # normalised again after the rotation, as the reference does
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return d_world + (v - d_world) * diff_scale

    return (cam_pos.expand(d_world.shape), d_world, aux(dxdy_cam[0]),
            aux(dxdy_cam[1]))
