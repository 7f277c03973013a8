"""Device-resident scene data for the training loop (port of
``mvsdf_tpu/train/device_data.py``).

Every per-image tensor (images, masks, depths, MVS cams, frozen CNN
features, view-selection graph) goes to the device once, when the trainer
starts; a step ships only the batch's image indices (B,) and the shared
pixel subset (P,) as int64 tensors, and the batch is gathered on the
device. The gather indexes the same source arrays with the same indices as
``SceneData.get_batch``, so the batch is the same element for element. Its
``pose`` is the ground truth; under camera optimisation the training step
puts the (B, 7) rows of the batch's images in its place.

Data parallel (``parallel/``): every rank holds the whole cache and draws
the same pixel subset; ``gather`` keeps the rank's slice of it for the
per-ray tensors (uv, object_mask, rgb), and the per-image ones stay whole.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import host_ray_slice


class DeviceSceneCache:
    """Scene tensors resident on ``device`` + on-device batch gather."""

    def __init__(self, scene, device):
        dev = torch.device(device)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        n = scene.n_images
        self.device = dev
        self.uv = put(scene.uv)                      # (HW, 2)
        self.rgb = put(scene.rgb)                    # (N, HW, 3)
        self.masks = put(scene.masks)                # (N, HW) bool
        self.intrinsics = put(scene.intrinsics)      # (N, 4, 4)
        self.poses = put(scene.poses)                # (N, 4, 4)
        self.depths = put(scene.depths)              # (N, 1, h, w)
        self.depth_cams = put(scene.depth_cams)      # (N, 2, 4, 4)
        self.size = float(scene.size)
        self.center = put(scene.center)              # (3,)
        self.has_feats = scene.feats is not None
        if self.has_feats:
            self.feats = scene.feats.to(dev)         # (N, C, h2, w2)
            self.cams_hd = put(scene.cams_hd)        # (N, 2, 4, 4)
            self.src_idx = put(np.asarray(
                [scene.src_indices(i) for i in range(n)], np.int64))

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in vars(self).values()
                   if isinstance(v, torch.Tensor))

    def gather(self, indices: torch.Tensor, sel: torch.Tensor) -> dict:
        """indices (B,) image ids, sel (P,) pixel ids, int64 on the device
        -> the batch dict the training step consumes, with this rank's
        share of the P rays."""
        sel = sel[host_ray_slice(sel.shape[0])]
        B, P = indices.shape[0], sel.shape[0]
        bi = indices[:, None]
        batch = {
            "indices": indices,
            "uv": self.uv[sel][None].expand(B, P, 2).contiguous(),
            "intrinsics": self.intrinsics[indices],
            "pose": self.poses[indices],
            "object_mask": self.masks[bi, sel[None, :]],
            "rgb": self.rgb[bi, sel[None, :]],
            # each image contributes its own reference-view depth map
            # (sel_depth_num=1, ref scene_dataset.py:132,203-206)
            "depths": self.depths[indices][:, None],
            "depth_cams": self.depth_cams[indices][:, None],
            "size": torch.full((B,), self.size, dtype=torch.float32,
                               device=self.device),
            "center": self.center[None].expand(B, 3).contiguous(),
        }
        if self.has_feats:
            srcs = self.src_idx[indices]             # (B, S)
            batch["feat"] = self.feats[indices]
            batch["feat_src"] = self.feats[srcs]
            batch["cam"] = self.cams_hd[indices]
            batch["src_cams"] = self.cams_hd[srcs]
        return batch
