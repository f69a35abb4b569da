"""Surface reconstruction from a finished run (counterpart of
`dqo_map_tpu/cli/make_mesh.py`).

    python -m dqo_map_tpu_torch.cli.make_mesh --config <cfg> --model <run_dir> \
        [--voxel 0.02] [--frame-step 10] [--gt-mesh pts.npy] [--device cuda]

Renders the depth of the newest saved map (`<run_dir>/save_model`) at
every Nth dataset camera, on the run's estimated poses (the blend kernel
K1 on the card), fuses the renders into a TSDF volume on the device
(`ops/tsdf.py`), and writes `save_model/mesh.ply`, the triangle mesh by
marching tetrahedra (`ops/marching.py`), and `save_model/tsdf_surface.ply`,
the volume's zero-crossing points. With GT surface points (`--gt-mesh`,
an (M,3) `.npy`) it scores samples of the mesh against them (`eval_pcd`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", required=True, help="run dir with save_model/")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--frame-step", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--gt-mesh", default=None,
                    help=".npy of GT surface points for P/R/F1")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..config import Config
    from ..data import Dataset
    from ..ops.marching import (marching_tetrahedra, sample_mesh_points,
                                write_mesh_ply)
    from ..ops.tsdf import extract_surface_points, fuse_frames
    from ..slam.renderer import Renderer, render_state
    from ..utils.ply import load_map_ply
    from .metric import find_model

    dev = args.device
    cfg = Config.from_yaml(args.config)
    dataset = Dataset(cfg.dataset)
    state = load_map_ply(find_model(args.model), args.capacity, device=dev)
    pose_file = os.path.join(args.model, "save_traj", "pose_es.npy")
    poses = np.load(pose_file) if os.path.exists(pose_file) else None

    cam0 = dataset[0]
    renderer = Renderer(cfg.map, cam0.width, cam0.height)
    cams, depths, colors = [], [], []
    for i in range(0, len(dataset), args.frame_step):
        frame = dataset[i]
        if poses is not None and i < len(poses):
            frame.update_pose(poses[i])
        with torch.no_grad():
            out = render_state(state, frame.render_inputs(dev),
                               renderer.settings)
        cams.append(frame)
        depths.append(out["depth"])
        colors.append(out["render"])
        print(f"rendered frame {i}")

    vol = fuse_frames(cams, depths, colors, voxel_size=args.voxel,
                      max_depth=cfg.map.max_depth, device=dev)
    verts, faces, vcols = marching_tetrahedra(
        vol.tsdf.cpu().numpy(), vol.weight.cpu().numpy(),
        vol.origin.cpu().numpy(), vol.voxel, vol.color.cpu().numpy())
    mesh_path = os.path.join(args.model, "save_model", "mesh.ply")
    write_mesh_ply(mesh_path, verts, faces, vcols)
    print(f"wrote {mesh_path}: {len(verts)} vertices, {len(faces)} faces")

    pts, cols, valid = extract_surface_points(vol)
    pts = pts[valid].cpu().numpy()
    cols = cols[valid].cpu().numpy()
    out_path = os.path.join(args.model, "save_model", "tsdf_surface.ply")
    _write_color_ply(out_path, pts, cols)
    print(f"wrote {out_path} with {len(pts)} surface points")

    result = {"mesh": mesh_path, "vertices": int(len(verts)),
              "faces": int(len(faces)), "surface": out_path,
              "surface_points": int(len(pts))}
    if args.gt_mesh and len(faces):
        from ..eval.evaluate import eval_pcd
        gt = np.load(args.gt_mesh)
        samples = sample_mesh_points(verts, faces, 200_000)
        m = eval_pcd(samples, gt, device=dev)
        print("mesh eval:", {k: round(v, 4) for k, v in m.items()})
        result["mesh_eval"] = m
    return result


def _write_color_ply(path, pts, cols):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        hdr = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.write(hdr.encode())
        rec = np.zeros(len(pts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = pts
        rec["rgb"] = np.clip(cols * 255, 0, 255).astype(np.uint8)
        f.write(rec.tobytes())


if __name__ == "__main__":
    main()
