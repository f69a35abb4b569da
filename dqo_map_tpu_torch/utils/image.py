"""Image-space geometry: vertex / normal / confidence maps, pyramids,
pooling, tile masks, pixel sampling, bilateral filter (counterpart of
`dqo_map_tpu/utils/image.py`). Maps are (H, W, C) float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pixel_grid(H: int, W: int, like: torch.Tensor):
    i = torch.arange(W, dtype=like.dtype, device=like.device)[None, :].expand(H, W)
    j = torch.arange(H, dtype=like.dtype, device=like.device)[:, None].expand(H, W)
    return i, j


def compute_vertex_map(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project depth (H,W) to camera-frame points (H,W,3)."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    H, W = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    i, j = _pixel_grid(H, W, depth)
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    return dirs * depth[..., None]


def sobel_gradient(img: torch.Tensor):
    """Per-channel Sobel x/y gradients with replicate padding, (H,W,C) each."""
    H, W, _ = img.shape
    p = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0]
    p = p.permute(1, 2, 0)                                    # (H+2, W+2, C)

    def s(dy, dx):
        return p[dy:dy + H, dx:dx + W]

    gx = (s(0, 2) - s(0, 0)) + 2.0 * (s(1, 2) - s(1, 0)) + (s(2, 2) - s(2, 0))
    gy = (s(2, 0) - s(0, 0)) + 2.0 * (s(2, 1) - s(0, 1)) + (s(2, 2) - s(0, 2))
    return gx, gy


def _normals(a: torch.Tensor, b: torch.Tensor, vertex_map: torch.Tensor):
    normal = torch.linalg.cross(a, b, dim=-1)
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-8)
    depth = vertex_map[:, :, -1]
    invalid = (depth <= depth.min()) | (depth >= depth.max())
    return torch.where(invalid[..., None], 0.0, normal)


def compute_normal_map(vertex_map: torch.Tensor) -> torch.Tensor:
    """Normals from a vertex map via the Sobel cross product dy x dx,
    zeroed at the min/max depth."""
    img_dx, img_dy = sobel_gradient(vertex_map)
    return _normals(img_dy, img_dx, vertex_map)


def compute_normal_map_icp(vertex_map: torch.Tensor) -> torch.Tensor:
    """ICP-side normal convention: dx x dy."""
    img_dx, img_dy = sobel_gradient(vertex_map)
    return _normals(img_dx, img_dy, vertex_map)


def compute_confidence_map(normal_map: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """|cos| between pixel normal and viewing ray, (H,W,1)."""
    H, W, _ = normal_map.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    i, j = _pixel_grid(H, W, normal_map)
    proj = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    proj = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-8)
    nn = normal_map / (torch.linalg.norm(normal_map, dim=-1, keepdim=True) + 1e-8)
    return torch.abs(torch.sum(nn * proj, dim=-1))[..., None]


def transform_map(m: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to an (...,3) point map."""
    return m @ T[:3, :3].T + T[:3, 3]


def rotate_map(m: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return m @ T[:3, :3].T


# --- pooling / pyramids -----------------------------------------------------

def _pool2d(x: torch.Tensor, stride: int, mode: str, pad_value: float) -> torch.Tensor:
    H, W = x.shape[:2]
    pad_h = (H + stride - 1) // stride * stride - H
    pad_w = (W + stride - 1) // stride * stride - W
    x = F.pad(x, (0, pad_w, 0, pad_h), value=pad_value)
    Hp, Wp = x.shape
    blocks = x.reshape(Hp // stride, stride, Wp // stride, stride)
    if mode == "max":
        return blocks.amax(dim=(1, 3))
    return blocks.mean(dim=(1, 3))


def maxpool(x: torch.Tensor, stride: int, pad_value: float = 0.0) -> torch.Tensor:
    return _pool2d(x, stride, "max", pad_value)


def meanpool(x: torch.Tensor, stride: int, pad_value: float = 0.0) -> torch.Tensor:
    return _pool2d(x, stride, "mean", pad_value)


def build_depth_pyramid(depth: torch.Tensor, levels: int) -> list:
    """Max-pooled depth pyramid, coarse -> fine; level i pools by
    2^(levels-1-i)."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    out = []
    for i in range(levels):
        k = 1 << (levels - 1 - i)
        out.append(depth if k == 1 else _pool2d(depth, k, "max", 0.0))
    return out


def build_vertex_pyramid(depth: torch.Tensor, K: torch.Tensor, levels: int) -> list:
    """Vertex maps of the depth pyramid, each with the intrinsics scaled to
    its level (`compute_vertex_map` reads only fx, fy, cx and cy, so the
    scaled matrix's last row is left as it falls: writing a constant into
    a card's tensor would wait for the card)."""
    out = []
    for i, d in enumerate(build_depth_pyramid(depth, levels)):
        out.append(compute_vertex_map(d, K * (1.0 / (1 << (levels - 1 - i)))))
    return out


def build_normal_pyramid(vertex_pyramid: list) -> list:
    return [compute_normal_map_icp(v) for v in vertex_pyramid]


# --- tile masks -------------------------------------------------------------

def pixelmask_to_tilemask(pixelmask: torch.Tensor, stride: int) -> torch.Tensor:
    return (maxpool(pixelmask.float(), stride) > 0).int()


def transmission_to_tilemask(pixelmask: torch.Tensor, stride: int,
                             tile_mask_ratio: float = 0.5) -> torch.Tensor:
    """Tiles where more than `tile_mask_ratio` of the pixels are active."""
    return (meanpool(pixelmask.float(), stride) > tile_mask_ratio).int()


def colorerror_to_tilemask(color_error: torch.Tensor, stride: int,
                           top_ratio: float = 0.4) -> torch.Tensor:
    """The top `top_ratio` of the tiles by mean colour error. Of tiles with
    equal error the lower index is taken first, as `lax.top_k` orders
    ties."""
    if color_error.dim() == 3:
        color_error = color_error[..., 0]
    down = meanpool(color_error, stride)
    k = int(down.numel() * top_ratio)
    mask = torch.zeros(down.numel(), dtype=torch.int32, device=down.device)
    if k > 0:
        order = torch.sort(down.reshape(-1), descending=True, stable=True).indices
        mask[order[:k]] = 1
    return mask.reshape(down.shape)


def tilemask_to_pixelmask(tile_mask: torch.Tensor, stride: int, H: int,
                          W: int) -> torch.Tensor:
    up = tile_mask.repeat_interleave(stride, 0).repeat_interleave(stride, 1)
    return up[:H, :W].bool()


# --- pixel sampling ---------------------------------------------------------

def sample_pixels(draws: torch.Tensor, select_mask: torch.Tensor,
                  max_samples: int, want_num):
    """Up to `max_samples` pixel indices drawn uniformly from `select_mask`.

    `draws` (H*W,) are uniform [0,1) numbers, one per pixel; the masked
    pixels with the largest draws are taken (the earlier index first among
    equal scores). Fixed output size `max_samples`, with a validity mask
    covering fewer masked pixels than requested and `want_num` below
    `max_samples`; a frame of fewer than `max_samples` pixels pads the
    output with invalid entries (pixel 0). Returns (flat_indices, valid),
    both (max_samples,).
    """
    flat_mask = select_mask.reshape(-1)
    n = flat_mask.shape[0]
    scores = draws + flat_mask.float() * 2.0
    idx = torch.sort(scores, descending=True, stable=True).indices[:max_samples]
    if n < max_samples:
        idx = torch.cat([idx, idx.new_zeros(max_samples - n)])
    rank = torch.arange(max_samples, device=idx.device)
    valid = flat_mask[idx] & (rank < want_num) & (rank < n)
    return idx, valid


# --- bilateral filter -------------------------------------------------------

def bilateral_filter(depth: torch.Tensor, radius: int, sigma_color: float,
                     sigma_space: float) -> torch.Tensor:
    """Depth-aware bilateral filter, (H,W,1)."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    h, w = depth.shape
    pad = F.pad(depth, (radius, radius, radius, radius))
    weight_sum = torch.zeros_like(depth)
    pixel_sum = torch.zeros_like(depth)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            if (i * i + j * j) > radius * radius:
                continue
            shifted = pad[radius + i:radius + i + h, radius + j:radius + j + w]
            spatial = -(i * i + j * j) / (2 * sigma_space**2)
            colorw = -((depth - shifted) ** 2) / (2 * sigma_color**2)
            wgt = torch.exp(spatial + colorw) * (shifted != 0)
            weight_sum = weight_sum + wgt
            pixel_sum = pixel_sum + wgt * shifted
    safe = torch.where(weight_sum == 0, 1.0, weight_sum)
    return torch.where(weight_sum == 0, 0.0, pixel_sum / safe)[..., None]
