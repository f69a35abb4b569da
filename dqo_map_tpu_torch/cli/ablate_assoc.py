"""Object-association ablation (counterpart of
`dqo_map_tpu/cli/ablate_assoc.py`): runs the object layer with each
association variant (iou / qd / iou_qd) over a sequence, on ground-truth
poses, and prints the resulting object tables, as the reference's
`eval_obj/results_accociation/` outputs list them.

    python -m dqo_map_tpu_torch.cli.ablate_assoc --config <cfg> [--out DIR]
    python -m dqo_map_tpu_torch.cli.ablate_assoc --synthetic 40 [--out DIR]

Every frame goes through the tracker's preprocessing (on `--device`); the
objects are refined on every 5th frame with detections (`refine_objects`,
on `--device`). With `--out`, each variant's `objects.txt` goes to
`only_iou/`, `only_qd/` or `iou_qd/` under it.
"""

from __future__ import annotations

import argparse
import os


def run_variant(cams, cfg, mode: str, device="cuda"):
    from ..models.quadrics import ObjectLayer
    from ..slam.tracker import Tracker

    cfg.raw["association"] = mode
    layer = ObjectLayer(cfg, device)
    tracker = Tracker(cfg.tracking, cams[0].width, cams[0].height,
                      device=device)
    for frame_id, frame in enumerate(cams):
        tracker.map_preprocess(frame, frame_id)
        frame.update_pose(frame.pose_gt)   # ground-truth poses isolate association
        if frame.detections:
            layer.process_frame(frame, frame_id)
            if frame_id % 5 == 0:
                layer.optimize_objects()
    return layer


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run on N synthetic frames instead of a dataset")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from ..config import Config, default_config

    if args.synthetic:
        from ..data.synthetic import synthetic_sequence
        cfg = default_config(type="Synthetic", use_object=True,
                             min_depth=0.1, max_depth=8.0)
        _, cams = synthetic_sequence(args.synthetic, with_detections=True)
    else:
        from ..data import Dataset
        cfg = Config.from_yaml(args.config)
        cams = Dataset(cfg.dataset).cameras

    rows = []
    for mode in ("iou", "qd", "iou_qd"):
        layer = run_variant(cams, cfg, mode, args.device)
        n_obs = sum(len(o.bboxes_) for o in layer.objects)
        rows.append((mode, len(layer.objects), n_obs))
        if args.out:
            d = os.path.join(args.out, f"only_{mode}" if mode != "iou_qd"
                             else "iou_qd")
            layer.save(d)
    print(f"{'mode':8s} {'objects':>8s} {'observations':>13s}")
    for mode, n, obs in rows:
        print(f"{mode:8s} {n:8d} {obs:13d}")
    return rows


if __name__ == "__main__":
    main()
