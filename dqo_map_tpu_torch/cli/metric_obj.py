"""Object-map evaluation (counterpart of `dqo_map_tpu/cli/metric_obj.py`).

    python -m dqo_map_tpu_torch.cli.metric_obj --pred <run>/save_obj/objects.txt \
        --gt <gt_boxes.txt>
    python -m dqo_map_tpu_torch.cli.metric_obj --per-object <run_dir> \
        --gt-mesh ID=path.ply [--gt-mesh ...] [--dist-thresh 0.01] \
        [--device cuda]

Box mode: both files hold `cat tx ty tz qx qy qz qw a1 a2 a3` rows (the
reference's box format); prints the oriented 3D-box IoU, the accuracy and
precision at IoU thresholds, the centre errors and the AP curve, as JSON.
Per-object mode: scores each object's exported Gaussians
(`save_model/frame_*/iter_*_obj<K>.ply`, which `Mapping.save_model`
writes) against the GT mesh or point cloud given for its id (`eval_pcd`,
on `--device`).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", help="predicted objects.txt (box mode)")
    ap.add_argument("--gt", help="GT box file (box mode)")
    ap.add_argument("--per-object", metavar="RUN_DIR",
                    help="per-object mesh eval: a finished run directory "
                         "(save_model/frame_*/iter_*_obj<K>.ply exports)")
    ap.add_argument("--gt-mesh", action="append", default=[],
                    metavar="ID=path.ply",
                    help="GT mesh (or point cloud) per object id; repeatable")
    ap.add_argument("--dist-thresh", type=float, default=0.01,
                    help="accuracy threshold in meters (ref: 1 cm)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.per_object:
        out = per_object_main(args)
        print(json.dumps(out, indent=2))
        return out

    from ..eval.obj_eval import (compute_ap_curve, evaluate_boxes,
                                 load_box_file, object_center_errors)

    pred = load_box_file(args.pred)
    gt = load_box_file(args.gt)
    out = evaluate_boxes(pred, gt)
    out.update(object_center_errors(pred, gt))
    out["ap_curve"] = compute_ap_curve(pred, gt)
    print(json.dumps(out, indent=2))
    return out


def per_object_main(args) -> dict:
    """{object id: {ply, n_points[, eval_pcd's metrics]}} over the run's
    newest per-object PLYs; with GT given, only the ids that have one."""
    import glob
    import os

    import numpy as np

    from ..eval.evaluate import eval_pcd
    from ..eval.obj_eval import load_gt_mesh_points
    from ..utils.ply import read_gaussian_ply

    gt_map = {}
    for spec in args.gt_mesh:
        oid, path = spec.split("=", 1)
        gt_map[int(oid)] = load_gt_mesh_points(path)

    plys = sorted(glob.glob(os.path.join(
        args.per_object, "save_model", "*", "*_obj*.ply")))
    results = {}
    for p in plys:
        oid = int(p.rsplit("_obj", 1)[1].split(".")[0])
        if gt_map and oid not in gt_map:
            continue
        d = read_gaussian_ply(p)
        entry = {"ply": p, "n_points": int(d["xyz"].shape[0])}
        if oid in gt_map:
            entry.update(eval_pcd(d["xyz"], np.asarray(gt_map[oid]),
                                  threshold=args.dist_thresh,
                                  device=args.device))
        results[oid] = entry
    return results


if __name__ == "__main__":
    main()
