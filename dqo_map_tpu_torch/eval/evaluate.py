"""Render quality and geometry evaluation (counterpart of
`dqo_map_tpu/eval/evaluate.py`): PSNR, SSIM, MS-SSIM, colour-L1, depth-L1
and the valid-depth ratio of a render against its frame, with the
comparison images written as JPEG at quality 75, as PIL writes them, and
point-cloud accuracy against a ground-truth sampling (`eval_pcd`).

LPIPS keeps the reference's contract: the `lpips` key is always present,
None with an `lpips_note` when it was not computed. It is computed only
when asked for (`with_lpips`) and torchmetrics with its pretrained AlexNet
is at hand.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.knn import knn
from ..utils.losses import l1_loss, ms_ssim, psnr, ssim
from ..utils.jpeg import write_jpeg


def _lpips(img1: torch.Tensor, img2: torch.Tensor) -> Optional[float]:
    """LPIPS (AlexNet) of two (H,W,3) images; None where torchmetrics or
    its pretrained weights are not at hand."""
    try:
        from torchmetrics.image.lpip import \
            LearnedPerceptualImagePatchSimilarity
        fn = LearnedPerceptualImagePatchSimilarity(net_type="alex",
                                                   normalize=True)
    except (ImportError, OSError) as e:
        print(f"[eval] LPIPS unavailable ({type(e).__name__}: {e}); "
              "omitting the metric")
        return None
    a = img1.permute(2, 0, 1)[None].float().cpu().clamp(0, 1)
    b = img2.permute(2, 0, 1)[None].float().cpu().clamp(0, 1)
    return float(fn(a, b))


def _depth_metrics(depth, index, gtd, min_depth: float, max_depth: float):
    """Depth-L1 (m) over the pixels with a hit and a ground-truth depth in
    range, the share of such pixels, and the range-gated ground truth."""
    gtd = torch.where((gtd > min_depth) & (gtd < max_depth), gtd, 0.0)
    invalid = (index == -1) | (gtd == 0)
    derr = torch.where(invalid, 0.0, torch.abs(gtd - depth))
    nvalid = (~invalid).sum()
    return (derr.sum() / torch.clamp(nvalid, min=1),
            nvalid / invalid.numel(), gtd)


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def eval_picture(render_output: dict, gt_color: np.ndarray,
                 gt_depth: np.ndarray, min_depth: float, max_depth: float,
                 save_path: Optional[str] = None,
                 with_lpips: bool = False) -> dict:
    """The metrics of a render (`render`, `depth`, `depth_index_map`)
    against its frame, computed on the render's device; depth-L1 in cm.
    With `save_path`, writes `color_compare.jpg` (render, frame, |error|;
    4:2:0) and `depth_compare.jpg` (render depth, frame depth; grey)
    there, at quality 75."""
    image = render_output["render"].detach()
    depth = render_output["depth"].detach()
    index = render_output["depth_index_map"]
    dev = image.device
    gt_img = torch.as_tensor(np.asarray(gt_color, np.float32), device=dev)
    chw, gt_chw = image.permute(2, 0, 1), gt_img.permute(2, 0, 1)
    dl1, vratio, gtd = _depth_metrics(
        depth, index, torch.as_tensor(np.asarray(gt_depth, np.float32),
                                      device=dev), min_depth, max_depth)
    metrics = {
        "psnr": float(psnr(gt_img, image)),
        "ssim": float(ssim(chw, gt_chw)),
        "ms_ssim": float(ms_ssim(chw, gt_chw)),
        "color_l1": float(l1_loss(gt_img, image)),
        "depth_l1_cm": float(dl1) * 100,
        "valid_ratio": float(vratio),
    }
    lp = _lpips(image, gt_img) if with_lpips else None
    metrics["lpips"] = lp
    if lp is None:
        metrics["lpips_note"] = (
            "not computed" if not with_lpips else
            "torchmetrics/pretrained-AlexNet unavailable (offline env)")

    if save_path:
        img, gt = image.cpu().numpy(), gt_img.cpu().numpy()
        write_jpeg(os.path.join(save_path, "color_compare.jpg"),
                   _to_u8(np.concatenate([img, gt, np.abs(img - gt)], axis=1)),
                   75)
        gtd = gtd.cpu().numpy()
        dmax = max(float(gtd.max()), 1e-6)
        write_jpeg(os.path.join(save_path, "depth_compare.jpg"),
                   _to_u8(np.concatenate([depth.cpu().numpy(), gtd], axis=1)
                          / dmax), 75)
    return metrics


def eval_frame(mapping, frame, save_path: Optional[str] = None,
               min_depth: float = 0.3, max_depth: float = 5.0,
               save_picture: bool = False, run_pcd: bool = False,
               gt_mesh_points: Optional[np.ndarray] = None) -> dict:
    """The model render of `mapping` at `frame` (a model render of the
    mapping's, on its device) against the frame. With `run_pcd` and
    `gt_mesh_points`, also `eval_pcd` of the map's alive Gaussian centres
    against those points."""
    out = mapping.get_render_output(frame.render_inputs(mapping.device))
    metrics = eval_picture(out, frame.image, frame.depth, min_depth,
                           max_depth, save_path if save_picture else None)
    if run_pcd and gt_mesh_points is not None:
        st = mapping.state
        alive = (st.status != 0).cpu().numpy()
        metrics.update(eval_pcd(st.xyz.detach().cpu().numpy()[alive],
                                gt_mesh_points, device=mapping.device))
    return metrics


def eval_pcd(points: np.ndarray, gt_points: np.ndarray,
             threshold: float = 0.03, sample: int = 200_000, seed: int = 0,
             device="cuda") -> dict:
    """Chamfer distance, accuracy, completion and precision / recall / F1
    at `threshold` between two point sets, each subsampled to `sample`
    points; nearest neighbours by the exact `knn`."""
    rng = np.random.default_rng(seed)
    if len(points) > sample:
        points = points[rng.choice(len(points), sample, replace=False)]
    if len(gt_points) > sample:
        gt_points = gt_points[rng.choice(len(gt_points), sample, replace=False)]
    p = torch.as_tensor(np.ascontiguousarray(points, np.float32), device=device)
    g = torch.as_tensor(np.ascontiguousarray(gt_points, np.float32),
                        device=device)
    d_pg, _ = knn(p, g, torch.ones(len(g), dtype=torch.bool, device=device), k=1)
    d_gp, _ = knn(g, p, torch.ones(len(p), dtype=torch.bool, device=device), k=1)
    d_pg, d_gp = torch.sqrt(d_pg), torch.sqrt(d_gp)
    acc = float(d_pg.mean())           # accuracy: prediction -> ground truth
    comp = float(d_gp.mean())          # completion: ground truth -> prediction
    precision = float((d_pg < threshold).float().mean())
    recall = float((d_gp < threshold).float().mean())
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    return {"chamfer_cm": (acc + comp) / 2 * 100, "accuracy_cm": acc * 100,
            "completion_cm": comp * 100, "precision": precision,
            "recall": recall, "f1": f1}
