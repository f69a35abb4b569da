"""Absolute trajectory error between two TUM-format trajectory files
(counterpart of `dqo_map_tpu/cli/eval_ate.py`): associate the stamps,
Horn-align the estimate to the ground truth, report the translational
error statistics.

    python -m dqo_map_tpu_torch.cli.eval_ate gt.txt est.txt \
        [--offset 0] [--max_difference 0.02] [--scale 1] [--verbose] \
        [--save_associations out.txt] [--plot ate.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.math3d import horn_align
from .associate import associate, read_stamped_file


def ate_statistics(gt_xyz: np.ndarray, es_xyz: np.ndarray):
    """Align es -> gt (Horn); returns (stats dict, aligned estimate (N,3))."""
    rot, trans, err = horn_align(es_xyz.T, gt_xyz.T)
    aligned = (rot @ es_xyz.T + trans).T
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "pairs": int(len(err)),
    }, aligned


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("gt_file", help="ground-truth TUM trajectory "
                                   "(stamp tx ty tz qx qy qz qw)")
    p.add_argument("est_file", help="estimated TUM trajectory")
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=1.0,
                   help="scale applied to the estimated trajectory")
    p.add_argument("--max_difference", type=float, default=0.02)
    p.add_argument("--save_associations", default=None)
    p.add_argument("--plot", default=None,
                   help="write a top-down trajectory plot (png)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    gt = read_stamped_file(args.gt_file)
    es = read_stamped_file(args.est_file)
    pairs = associate(gt, es, args.offset, args.max_difference)
    if len(pairs) < 2:
        raise SystemExit(
            "Couldn't associate trajectories — check stamps/--offset/"
            "--max_difference")
    gt_xyz = np.array([[float(v) for v in gt[sa][:3]] for sa, _ in pairs])
    es_xyz = np.array([[float(v) * args.scale for v in es[sb][:3]]
                       for _, sb in pairs])
    stats, aligned = ate_statistics(gt_xyz, es_xyz)

    if args.verbose:
        print(f"compared_pose_pairs {stats['pairs']} pairs")
        for k in ("rmse", "mean", "median", "std", "min", "max"):
            print(f"absolute_translational_error.{k} {stats[k]:f} m")
    else:
        print(f"{stats['rmse']:f}")

    if args.save_associations:
        with open(args.save_associations, "w") as f:
            for (sa, sb), g, e in zip(pairs, gt_xyz, es_xyz):
                f.write(f"{sa:f} {g[0]:f} {g[1]:f} {g[2]:f} "
                        f"{sb:f} {e[0]:f} {e[1]:f} {e[2]:f}\n")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], "k-", label="ground truth")
        ax.plot(aligned[:, 0], aligned[:, 1], "b-", label="estimated")
        for g, a in zip(gt_xyz[::5], aligned[::5]):
            ax.plot([g[0], a[0]], [g[1], a[1]], "r-", alpha=0.4, lw=0.5)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.legend()
        ax.set_title(f"ATE RMSE {stats['rmse'] * 100:.2f} cm")
        fig.savefig(args.plot, dpi=120)
    return stats


if __name__ == "__main__":
    main()
