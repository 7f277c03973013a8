"""The training cells' inputs as the reference reads them from the scene
directory the benchmark wrote: cameras (``cameras_hd.npz``, MVS camera
text files, ``pair.txt``), PFM depth maps, the images and masks as the
``.npy`` arrays written beside their PNG files, and the frozen features of
Vis-MVSNet's FeatExt computed here from ``featext.pt``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def decompose(P: np.ndarray):
    """P = K [R | t] (3, 4) -> (intrinsics 4x4, camera-to-world pose 4x4),
    K with a positive diagonal and K[2, 2] = 1, R a proper rotation."""
    P = np.asarray(P, np.float64)[:3, :4]
    M = P[:, :3]
    J = np.eye(3)[::-1]
    Q, R = np.linalg.qr((J @ M).T)
    K = J @ R.T @ J
    Rot = J @ Q.T
    D = np.diag(np.sign(np.diag(K)))
    K, Rot = K @ D, D @ Rot
    if np.linalg.det(Rot) < 0:
        Rot, K = -Rot, -K
    c = -np.linalg.inv(M) @ P[:, 3]
    intr = np.eye(4)
    intr[:3, :3] = K / K[2, 2]
    pose = np.eye(4)
    pose[:3, :3] = Rot.T
    pose[:3, 3] = c
    return intr.astype(np.float32), pose.astype(np.float32)


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"Pf":
            raise ValueError(f"{path}: not a grey PFM")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f4")
    return np.ascontiguousarray(data.reshape(h, w)[::-1], np.float32)


def read_cam(path: str) -> np.ndarray:
    """MVS camera text -> (2, 4, 4): the extrinsic, then K in [1][:3, :3]
    and (depth_min, interval, 256, depth_max) in [1][3]."""
    words = open(path).read().split()
    cam = np.zeros((2, 4, 4))
    cam[0] = np.array(words[1:17], np.float64).reshape(4, 4)
    cam[1][:3, :3] = np.array(words[18:27], np.float64).reshape(3, 3)
    d0, dd = float(words[27]), float(words[28])
    cam[1][3] = [d0, dd, 256, d0 + dd * 255]
    return cam.astype(np.float32)


def read_pair(path: str):
    """{view id: its first two source view ids} in file order."""
    lines = open(path).read().split("\n")
    out = {}
    for i in range(int(lines[0])):
        toks = lines[2 + 2 * i].split()
        out[int(lines[1 + 2 * i])] = [int(t) for t in toks[1::2]][:2]
    return out


class Scene:
    """What a training batch needs, on ``device``."""

    def __init__(self, root: str, device, feat_scale: int = 2):
        data = os.path.join(root, "scene")
        cams = np.load(os.path.join(data, "cameras_hd.npz"))
        n = sum(k.startswith("world_mat_") for k in cams.files)
        self.n = n
        self.device = device
        intr, pose = zip(*(decompose((cams[f"world_mat_{i}"].astype(
            np.float32) @ cams[f"scale_mat_{i}"].astype(np.float32))[:3])
            for i in range(n)))
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.intrinsics, self.poses = put(np.stack(intr)), put(np.stack(pose))
        scale = cams["scale_mat_0"].astype(np.float32)
        self.size = float(scale[0, 0] * 2)
        self.center = put(scale[:3, 3])
        self.images = np.load(os.path.join(root, "images.npy"), mmap_mode="r")
        self.masks = np.load(os.path.join(root, "masks.npy"), mmap_mode="r")
        H, W = self.images.shape[1:3]
        self.hw = (H, W)
        ys, xs = np.mgrid[0:H, 0:W]
        self.uv = put(np.stack([xs.ravel(), ys.ravel()], -1)
                      .astype(np.float32))
        depth_files = sorted(os.listdir(os.path.join(data, "depth")))
        self.depths = put(np.stack([read_pfm(os.path.join(data, "depth", f))
                                    for f in depth_files])[:, None])
        dc = np.stack([read_cam(os.path.join(root, f"cam_{i:08}_flow3.txt"))
                       for i in range(n)])
        self.depth_cams = put(dc)
        hd = dc.copy()
        hd[:, 1, 0, [0, 2]] *= feat_scale
        hd[:, 1, 1, [1, 2]] *= feat_scale
        self.cams_hd = put(hd)
        pair = read_pair(os.path.join(root, "pair.txt"))
        self.src = torch.tensor([pair[i] for i in range(n)], device=device)
        self.feat_hw = tuple(feat_scale * s for s in self.depths.shape[-2:])
        self.featext = torch.load(os.path.join(root, "featext.pt"))
        self.feats = {}

    def features(self, views) -> None:
        """Computes the frozen features of ``views`` not computed yet."""
        todo = sorted(set(int(v) for v in views) - set(self.feats))
        sd = {k: v.to(self.device) for k, v in self.featext.items()}
        mean = torch.tensor(MEAN, device=self.device)[:, None, None]
        std = torch.tensor(STD, device=self.device)[:, None, None]
        with torch.no_grad():
            for v in todo:
                x = self.rgb_image(v)[None]
                if x.shape[-2:] != self.feat_hw:
                    x = F.interpolate(x, size=self.feat_hw, mode="bilinear",
                                      align_corners=False)
                self.feats[v] = featext(sd, (x / 2 + 0.5 - mean) / std)[0]

    def rgb_image(self, v: int) -> torch.Tensor:
        """(3, H, W) in [-1, 1]."""
        img = torch.from_numpy(np.array(self.images[v])).to(self.device)
        return (img.float() / 255.0 - 0.5).mul(2.0).permute(2, 0, 1)

    def batch(self, indices, sel) -> dict:
        """The batch of images ``indices`` (B,) at pixels ``sel`` (P,)."""
        idx = torch.as_tensor(np.asarray(indices), device=self.device).long()
        sel = torch.as_tensor(np.asarray(sel), device=self.device).long()
        B, P = len(idx), len(sel)
        rgb = torch.stack([self.rgb_image(int(i)).reshape(3, -1)[:, sel].T
                           for i in idx])
        mask = torch.stack([torch.from_numpy(np.array(self.masks[int(i)])
                                             ).to(self.device).reshape(-1)[sel]
                            for i in idx])
        srcs = self.src[idx]
        self.features(idx.tolist() + srcs.reshape(-1).tolist())
        feat = lambda ids: torch.stack([self.feats[int(i)] for i in ids])
        return {
            "uv": self.uv[sel][None].expand(B, P, 2),
            "intrinsics": self.intrinsics[idx], "pose": self.poses[idx],
            "object_mask": mask, "rgb": rgb,
            "depths": self.depths[idx], "depth_cams": self.depth_cams[idx],
            "size": self.size, "center": self.center,
            "feat": feat(idx),
            "feat_src": torch.stack([feat(s) for s in srcs]),
            "cam": self.cams_hd[idx], "src_cams": self.cams_hd[srcs],
        }


def _bn(sd, p, x):
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"],
                        sd[p + ".weight"], sd[p + ".bias"], False, 0.0, 1e-5)


def _block(sd, p, x, stride):
    out = F.relu(_bn(sd, p + ".bn1", F.conv2d(x, sd[p + ".conv1.weight"],
                                               stride=stride, padding=1)))
    out = _bn(sd, p + ".bn2", F.conv2d(out, sd[p + ".conv2.weight"],
                                       padding=1))
    if p + ".downsample.0.weight" in sd:
        x = _bn(sd, p + ".downsample.1",
                F.conv2d(x, sd[p + ".downsample.0.weight"], stride=stride))
    return F.relu(out + x)


def featext(sd: dict, x: torch.Tensor) -> torch.Tensor:
    """Vis-MVSNet's FeatExt (a residual U-Net) on ImageNet-normalized
    images (N, 3, H, W) -> its half-resolution head (N, 32, H/2, W/2)."""
    x = F.relu(_bn(sd, "init_conv.1", F.conv2d(
        x, sd["init_conv.0.weight"], stride=2, padding=2)))
    enc = []
    for i, name in enumerate(("2d2_0", "2d4_1", "2d8_2")):
        p = f"unet.enc_blocks.{name}"
        x = _block(sd, p + ".1", _block(sd, p + ".0", x, 1 if i == 0 else 2),
                   1)
        enc.append(x)
    for i, name in enumerate(("2d16_3", "2d8_4")):
        p = f"unet.dec_blocks.{name}"
        x = F.conv_transpose2d(x, sd[p + ".0.weight"], stride=2, padding=1,
                               output_padding=1)
        x = torch.cat([x, enc[-2 - i]], 1)
        x = _block(sd, p + ".2.0", F.conv2d(x, sd[p + ".1.weight"],
                                            padding=1), 1)
    return F.conv2d(x, sd["final_conv_3.weight"], padding=1)

