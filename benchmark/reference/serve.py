"""Plain PyTorch serving path: projection, features, forward, KNN vote.

A frozen, straightforward copy of what labelling a scan means in the
COARSE3D reference (RangeNet++-style spherical projection, nearest point
wins a pixel with ties to the lowest index; 5-channel features normalised
by the sensor's statistics on hit pixels; argmax of the logits; KNN range
vote over an S x S window, lidar-bonnetal's ``postproc/knn.py``). Nothing
here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EMPTY = 3.0e38


def fov(sensor: dict):
    down = math.radians(sensor["fov_down"])
    vert = math.radians(abs(sensor["fov_up"])) + abs(down)
    left = math.radians(sensor["fov_left"])
    hori = abs(left) + math.radians(abs(sensor["fov_right"]))
    return down, vert, left, hori


def project(points: torch.Tensor, valid: torch.Tensor, sensor: dict):
    """(B, P, 4) padded clouds -> range image, feature image, per-point
    pixels and depth."""
    b, p, c = points.shape
    h, w = sensor["proj_h"], sensor["proj_w"]
    hw = h * w
    xyz = points[..., :3]
    depth = torch.sqrt((xyz * xyz).sum(-1))
    down, vert, left, hori = fov(sensor)
    yaw = -torch.atan2(xyz[..., 1], xyz[..., 0])
    pitch = torch.asin(torch.clamp(xyz[..., 2] / torch.clamp_min(depth, 1e-12),
                                   -1.0, 1.0))
    fx = (yaw + abs(left)) / hori * w
    fy = (1.0 - (pitch + abs(down)) / vert) * h
    px = torch.clamp(torch.floor(fx), 0, w - 1).to(torch.int32)
    py = torch.clamp(torch.floor(fy), 0, h - 1).to(torch.int32)
    flat = torch.where(valid, py * w + px, hw).long()
    base = torch.arange(b, device=points.device)[:, None] * hw
    idx = torch.where(valid, base + flat, b * hw).reshape(-1)
    best = torch.full((b * hw + 1,), EMPTY, device=points.device)
    best.scatter_reduce_(0, idx, depth.reshape(-1), "amin")
    win = valid.reshape(-1) & (depth.reshape(-1) == best[idx])
    ids = torch.arange(p, device=points.device, dtype=torch.int32).repeat(b)
    winner = torch.full((b * hw + 1,), p, dtype=torch.int32,
                        device=points.device)
    winner.scatter_reduce_(0, idx, torch.where(win, ids, p), "amin")
    winner = winner[:-1].view(b, hw)
    hit = winner < p
    rng_img = torch.where(hit, best[:-1].view(b, hw), -1.0)
    rows = points.reshape(b * p, c)[
        (torch.arange(b, device=points.device)[:, None] * p
         + winner.clamp(0, p - 1).long()).reshape(-1)]
    img = torch.where(hit.reshape(-1, 1), rows, -1.0).view(b, h, w, c)
    rng_img = rng_img.view(b, h, w)
    inten = torch.where(img[..., 3] == -1.0, 0.0, img[..., 3])
    feats = torch.cat([rng_img[..., None], img[..., :3], inten[..., None]], -1)
    return {"range": rng_img, "features": feats, "hit": hit.view(b, h, w),
            "px": px, "py": py, "depth": depth}


def normalize(feats: torch.Tensor, mask: torch.Tensor, sensor: dict):
    mean = torch.tensor(sensor["img_mean"], device=feats.device)
    std = torch.tensor(sensor["img_stds"], device=feats.device)
    return (feats - mean) / std * mask[..., None].float()


def _inv_gauss(size: int, sigma: float) -> np.ndarray:
    c = np.arange(size, dtype=np.float64)
    xg, yg = np.meshgrid(c, c, indexing="xy")
    mu, var = (size - 1) / 2.0, float(sigma) ** 2
    g = np.exp(-((xg - mu) ** 2 + (yg - mu) ** 2) / (2 * var)) / (2 * np.pi
                                                                   * var)
    return (1.0 - g / g.sum()).reshape(-1).astype(np.float32)


def knn_vote(rng_img, depth, argmax, px, py, n_classes, knn, search, sigma,
             cutoff):
    """Per point: the S x S window of (range, label) around its pixel, the
    centre's range replaced by its own, distances |dr| * (1 - gauss), the
    k nearest, those past ``cutoff`` vote for nothing, majority over
    classes 1..C-1 (lowest class on a tie)."""
    b, h, w = rng_img.shape
    pad = (search - 1) // 2
    s2 = search * search
    r = torch.where(rng_img < 0, EMPTY, rng_img)
    lab = argmax.to(torch.int64)
    rp = F.pad(r, (pad,) * 4, value=0.0)
    lp = F.pad(lab, (pad,) * 4, value=0)
    rw = torch.stack([rp[:, dy:dy + h, dx:dx + w] for dy in range(search)
                      for dx in range(search)], -1).reshape(b * h * w, s2)
    lw = torch.stack([lp[:, dy:dy + h, dx:dx + w] for dy in range(search)
                      for dx in range(search)], -1).reshape(b * h * w, s2)
    idx = (torch.arange(b, device=r.device)[:, None] * (h * w)
           + py.long() * w + px.long()).reshape(-1)
    nr, nl = rw[idx].view(b, -1, s2).clone(), lw[idx].view(b, -1, s2)
    nr[..., s2 // 2] = depth
    g = torch.from_numpy(_inv_gauss(search, sigma)).to(r.device)
    dist = torch.abs(nr - depth[..., None]) * g
    # ties between equal distances go to the lower window position
    order = torch.sort(dist, dim=-1, stable=True).indices[..., :knn]
    kd = torch.gather(dist, -1, order)
    kl = torch.gather(nl, -1, order)
    if cutoff > 0:
        kl = torch.where(kd > cutoff, n_classes, kl)
    classes = torch.arange(1, n_classes, device=r.device)
    votes = (kl[..., None] == classes).sum(-2)
    return (torch.argmax(votes, -1) + 1).to(torch.int32)


@torch.no_grad()
def labels(model, points, valid, sensor: dict, n_classes: int, knn: dict,
           block: int = 4):
    """Per-point labels of (B, P, 4) clouds through ``model`` (eval mode),
    ``block`` scans at a time."""
    out = []
    for s in range(0, points.shape[0], block):
        pts, val = points[s:s + block], valid[s:s + block]
        proj = project(pts, val, sensor)
        x = normalize(proj["features"], proj["hit"], sensor)
        logits = model(x.permute(0, 3, 1, 2).contiguous())["logits"]
        arg = torch.argmax(logits, dim=1)
        out.append(knn_vote(proj["range"], proj["depth"], arg, proj["px"],
                            proj["py"], n_classes, **knn))
    return torch.cat(out)
