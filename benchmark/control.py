"""The control of the benchmark's check, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --frames <n> \
        --seeds <s> [<s> ...]

For each seed: the reference's film of frames [0, n) at the seed's tiles,
and the same computed with its state rounded to bfloat16 (the control,
in the program's place), compared as a run compares the program's film.
One JSON line a seed. The benchmark's runs never run it; its readings set
the upper end of each limit (``limits/<cell>.json``).
"""

import json
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

from harness import check, manifest, runner, workload  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    man = manifest.load_manifest()
    entry = manifest.cell(man, args.workload)
    cfg = manifest.config(man, entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    limits = manifest.limits(args.workload)
    for seed in args.seeds:
        camera = workload.moved_camera(cfg, traffic, seed)
        tiles = workload.check_tiles(seed, traffic)
        ref = runner.reference_film(cfg, traffic, camera, tiles, args.frames,
                                    args.device)
        ctl = runner.reference_film(cfg, traffic, camera, tiles, args.frames,
                                    args.device, control=torch.bfloat16)
        numbers = check.compare(ctl, ref)
        correct, _ = check.judge(numbers, limits)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              frames=args.frames, control="bfloat16",
                              correct=correct, **numbers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
