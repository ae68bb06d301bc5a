"""Perspective camera (host numpy) and batched ray generation (tensors).

Port of ``pathtracer_tpu/core/camera.py``: raster-space sample positions
(N, 2) in, world-space ray origins/directions (N, 3) out, and with
``generate_rays_diff`` the two auxiliary directions of the ray
differentials that pick the texture mip level. ``project_points`` runs
the chain backwards (world points to raster positions) for the light
tracer's camera connections.
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


    def project_params(self, device):
        """World -> raster projection for the light tracer's camera
        connections, float32 tensors: (cam_to_raster (4,4), w2c_rot
        (3,3), w2c_pos (3,), fwd_world (3,), importance 0-d), where
        importance is z0^2 / A_pix (z0 the image plane's distance, A_pix
        its area a pixel), the constant of the pinhole's importance that
        turns flux at the pinhole into pixel-mean radiance."""
        w2c = np.linalg.inv(self.cam_to_world)
        c2r = np.linalg.inv(self.raster_to_camera)
        z0 = abs(float(transform_point(self.raster_to_camera,
                                       np.zeros(3))[2]))
        a_pix = float(np.linalg.norm(np.cross(self.dx_camera,
                                              self.dy_camera)))
        fwd = -self.cam_to_world[:3, 2]  # the camera looks down -z

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return (t(c2r), t(w2c[:3, :3]), t(w2c[:3, 3]), t(fwd),
                t(z0 * z0 / max(a_pix, 1e-30)))


def _rows_times(m, v):
    """v @ m.T for (..., k) vectors and a (j, k) matrix, summed in index
    order (no BLAS, so the CPU and the card round alike)."""
    out = v[..., 0:1] * m[:, 0]
    for k in range(1, m.shape[1]):
        out = out + v[..., k:k + 1] * m[:, k]
    return out


def project_points(cam_to_raster, w2c_rot, w2c_pos, p_world):
    """World points (..., 3) -> (raster (..., 2), z_cam (...,)). Points
    with z_cam >= 0 lie behind the pinhole (it looks down -z): the caller
    culls them before reading their raster position."""
    p_cam = _rows_times(w2c_rot, p_world) + w2c_pos
    ph = torch.cat([p_cam, torch.ones_like(p_cam[..., :1])], dim=-1)
    pr = _rows_times(cam_to_raster, ph)
    w = torch.where(torch.abs(pr[..., 3:4]) > 1e-20, pr[..., 3:4], 1e-20)
    return pr[..., :2] / w, p_cam[..., 2]


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
