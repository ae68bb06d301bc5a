"""What a seed makes of a cell: each job's camera, and the tiles the
check reads.

One general generator for every traffic file. ``--seed`` and the job's
number move the configuration's published camera a little
(``camera_move`` in the traffic file: a yaw about the camera's up axis
and a pitch about its right axis, each uniform within
+-``yaw_deg`` / ``pitch_deg``, and an eye offset uniform in a ball of
``eye_frac`` of the scene's bounding-box diagonal), so that every job's
rays change while the share of each surface in view stays nearly the
same: a viewer's user nudging the camera, or the frames of a slow pan.
The seed also draws the film tiles that the check compares
(``check.tiles`` tiles of ``check.tile_px`` pixels a side).
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int, job: int = 0) -> np.random.Generator:
    """A generator of its own for each use of a seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), int(seed < 0), stream,
                                  job])


def _axis_rotation(axis, angle: float) -> np.ndarray:
    """Rodrigues' rotation by ``angle`` radians about the unit ``axis``."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def camera_move(seed: int, move: dict, diagonal: float,
                job: int = 0) -> dict:
    """The job's draw: yaw and pitch (degrees), eye offset (world)."""
    g = rng(seed, 0, job)
    yaw = g.uniform(-move["yaw_deg"], move["yaw_deg"])
    pitch = g.uniform(-move["pitch_deg"], move["pitch_deg"])
    v = g.normal(size=3)
    v = v / np.linalg.norm(v) * g.uniform() ** (1.0 / 3.0)
    return dict(yaw_deg=float(yaw), pitch_deg=float(pitch),
                eye_offset=(v * move["eye_frac"] * diagonal).tolist())


def moved_camera(config: dict, traffic: dict, seed: int,
                 job: int = 0) -> dict:
    """The camera numbers of job ``job`` of this seed's run:
    ``cam_to_world`` (4, 4) with the move applied, and the published
    ``fovy``, ``znear``, ``zfar``; ``move`` is the draw itself."""
    pub = config["camera"]
    c2w = np.asarray(pub["cam_to_world"], np.float64)
    move = camera_move(seed, traffic["camera_move"], config["bbox_diagonal"],
                       job)
    rot = c2w[:3, :3]
    turn = (_axis_rotation(rot[:, 1], np.radians(move["yaw_deg"]))
            @ _axis_rotation(rot[:, 0], np.radians(move["pitch_deg"])))
    out = np.eye(4)
    out[:3, :3] = turn @ rot
    out[:3, 3] = c2w[:3, 3] + np.asarray(move["eye_offset"])
    return dict(cam_to_world=out.tolist(), fovy=pub["fovy"],
                znear=pub["znear"], zfar=pub["zfar"], move=move)


def check_tiles(seed: int, traffic: dict) -> list:
    """The check's tiles: (x, y) top-left corners of ``tiles`` squares of
    ``tile_px`` pixels inside the image, uniform over it."""
    w, h = traffic["resolution"]
    n, size = traffic["check"]["tiles"], traffic["check"]["tile_px"]
    g = rng(seed, 1)
    xs = g.integers(0, w - size + 1, size=n)
    ys = g.integers(0, h - size + 1, size=n)
    return [(int(x), int(y)) for x, y in zip(xs, ys)]
