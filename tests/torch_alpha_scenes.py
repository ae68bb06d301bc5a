"""Alpha-masked test scenes for either package's SceneBuilder, and rays
that cross their masks. Imports neither JAX nor the JAX package, so the
card tests can use it where JAX is absent."""

import numpy as np

from pathtracer_tpu_torch.scene.scene import MAT_MATTE, SceneBuilder

IDX = np.array([[0, 1, 2], [0, 2, 3]])
UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def build(cls, fill, device="cpu"):
    """Build with either package's SceneBuilder: ``fill(builder)`` adds
    the content; the port's scene lands on ``device``."""
    b = cls()
    fill(b)
    return b.build(device=device) if cls is SceneBuilder else b.build()


def cutout_fill(alpha_img):
    """Floor at y=0, a masked quad at y=1, a point light at y=3 (the
    scene of tests/test_alpha.py)."""
    def fill(b):
        floor = b.add_material(mtype=MAT_MATTE, kd=(0.8, 0.8, 0.8))
        quad_m = b.add_material(mtype=MAT_MATTE, kd=(0.2, 0.8, 0.2))
        a_txd = b.add_texture_image(np.repeat(alpha_img[..., None], 3, -1))
        b.add_mesh(np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                            np.float32), IDX, None, UV, floor)
        b.add_mesh(np.array([[-2, 1, -2], [2, 1, -2], [2, 1, 2], [-2, 1, 2]],
                            np.float32), IDX, None, UV, quad_m,
                   alpha_txd=a_txd)
        b.add_point_light((0.0, 3.0, 0.0), (50.0, 50.0, 50.0))
    return fill


def sheets_fill(nx, nz, heights=(1.0, 1.55), floor=True, seed=7):
    """Stacked sheets of nx x nz masked unit quads (2 triangles each) over
    an optional floor, under a point light. The mask is random, half its
    texels 0, so bilinear values at texel edges are partial."""
    rng = np.random.default_rng(seed)
    alpha = np.where(rng.random((8, 8)) < 0.5, 0.0,
                     rng.uniform(0.2, 1.0, (8, 8))).astype(np.float32)

    def fill(b):
        floor_m = b.add_material(mtype=MAT_MATTE, kd=(0.8, 0.8, 0.8))
        leaf_m = b.add_material(mtype=MAT_MATTE, kd=(0.2, 0.8, 0.2))
        a_txd = b.add_texture_image(np.repeat(alpha[..., None], 3, -1))
        if floor:
            b.add_mesh(np.array([[-12, 0, -12], [12, 0, -12], [12, 0, 12],
                                 [-12, 0, 12]], np.float32), IDX, None, UV,
                       floor_m)
        for gy, height in enumerate(heights):
            for i in range(nx):
                for j in range(nz):
                    cx = -nx / 2 + i + 0.3 * gy
                    cz = -nz / 2 + j + 0.2 * gy
                    q = np.array([[cx, height, cz], [cx + 1, height, cz],
                                  [cx + 1, height, cz + 1],
                                  [cx, height, cz + 1]], np.float32)
                    b.add_mesh(q, IDX, None, UV, leaf_m, alpha_txd=a_txd)
        b.add_point_light((0.0, 4.0, 0.0), (60.0, 60.0, 60.0))
    return fill


# route -> (scene fill, use_bvh, the field that marks the route)
ROUTES = {
    "brute": (sheets_fill(6, 5), False, None),
    "dense": (sheets_fill(8, 8), True, "split_alpha"),
    "tree": (sheets_fill(18, 9), True, "bwa_rows"),
    "binary": (sheets_fill(6, 6, floor=False), True, "bvh_nodes"),
}


def rays(seed, n=384, extent=7.0):
    """Closest-hit rays from above, tilted, and shadow feelers from the
    floor up to the light."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-extent, extent, n), np.full(n, 3.0),
                  rng.uniform(-extent, extent, n)], -1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.15, n), -np.ones(n),
                  rng.normal(0, 0.15, n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o2 = np.stack([rng.uniform(-extent, extent, n), np.full(n, 0.01),
                   rng.uniform(-extent, extent, n)], -1).astype(np.float32)
    d2 = (np.array([0.0, 4.0, 0.0], np.float32) - o2)
    t2 = (np.linalg.norm(d2, axis=-1) * 0.999).astype(np.float32)
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, o2, d2, t2


def foliage_rays(sd, n, seed=0):
    """Rays aimed at random masked triangles of a scene from 0.5 to 3
    units away, so every one crosses the foliage: (o, d) host arrays."""
    rng = np.random.default_rng(seed)
    masked = np.nonzero(sd.tri_alpha_txd.numpy() >= 0)[0]
    tri = rng.choice(masked, n)
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    target = (w[:, 0:1] * sd.p0.numpy()[tri] + w[:, 1:2] * sd.p1.numpy()[tri]
              + w[:, 2:3] * sd.p2.numpy()[tri])
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (target - d * rng.uniform(0.5, 3.0, (n, 1))).astype(np.float32)
    return o, d
