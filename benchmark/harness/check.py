"""The comparison that decides ``correct``.

The program's film, as the window's last pass handed it over (a viewer's
newest finished job where there is one), is read at the check's tiles
and held against the reference's film of the same sample frames at the
same pixels. Three numbers, each with a limit of its own
(``limits/<cell>.json`` gives them, with the readings they were set
from):

- ``off_px_pct``: the share (%) of compared pixels of which some colour
  channel lies off the reference's by more than 1e-3 of (its value + the
  tiles' mean value); a path that takes another turn on rounding moves
  its pixels by far more, the rounding of one sum by far less;
- ``weight_rel_max``: the largest relative gap of the filter-weight
  channel, which only the sample positions and the splat set;
- ``mean_rel``: the relative gap of the compared pixels' summed colour.

A value that is not finite reads as off.
"""

from __future__ import annotations

import numpy as np

REL = 1e-3
NUMBERS = ("off_px_pct", "weight_rel_max", "mean_rel")


def read_tiles(film, tiles, size: int) -> np.ndarray:
    """(n, size, size, 4) host array of the film's (H, W, 4) tiles."""
    return np.stack([film[y:y + size, x:x + size].detach().cpu().numpy()
                     for x, y in tiles]).astype(np.float64)


def compare(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The three numbers of ``prog`` against ``ref``, both (n, s, s, 4)."""
    p_rgb, r_rgb = prog[..., :3], ref[..., :3]
    scale = float(np.mean(np.abs(r_rgb)))
    ok = np.abs(p_rgb - r_rgb) <= REL * (np.abs(r_rgb) + scale)
    off = ~np.all(ok, axis=-1)
    pw, rw = prog[..., 3], ref[..., 3]
    w_gap = np.abs(pw - rw) / np.maximum(np.abs(rw), 1e-30)
    total = float(np.sum(r_rgb))
    p_total = float(np.sum(p_rgb))
    mean_rel = abs(p_total - total) / max(abs(total), 1e-30)
    return dict(
        off_px_pct=100.0 * float(np.mean(off)),
        weight_rel_max=float(np.max(w_gap)) if np.all(np.isfinite(w_gap))
        else float("inf"),
        mean_rel=mean_rel if np.isfinite(mean_rel) else float("inf"))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    is at or under its limit."""
    out = {k: dict(value=numbers[k], limit=limits[k]["limit"])
           for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in out.values()), out
