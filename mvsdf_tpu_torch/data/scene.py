"""Per-scene dataset: images, masks, cameras, MVS depth maps, frozen CNN
features, and the per-epoch ray-subset sampler (port of
``mvsdf_tpu/data/scene.py``).

Behavioral parity target: ``code/datasets/scene_dataset.py`` (SceneDataset).
Directory layout (ref BYOD.md / vismvsnet2mvsdf):
    <data_dir>/image_hd/*.png        RGB in [-1, 1] after load
    <data_dir>/mask_hd/*.png         object masks
    <data_dir>/cameras_hd.npz        world_mat_i (K[R|t]) + scale_mat_i
    <data_dir>/cameras_linear_init.npz  optional initial cameras for
                                     camera optimisation (same keys)
    <data_dir>/depth/%03d.pfm        MVS depth maps
    <data_dir>/../pair.txt           view-selection graph
    <data_dir>/../cam_%08d_flow3.txt MVS cameras (2x4x4)
    <data_dir>/pmask/                optional perfect masks for eval

Every field is the JAX package's numpy array but ``feats``: the frozen
FeatExt features are computed on the scene's device (``cuda`` unless the
caller names another) in batches of 20 views and stay there, a tensor
(N, 32, h2, w2). The images are PNG, decoded by ``data/png.py``; for a
scene on the card its row filters are undone by the host C function.
``timings`` holds what loading took.
"""
from __future__ import annotations

import os
import time
import warnings
from glob import glob
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import formats
from .featext import deterministic_cudnn, init_feat_ext, \
    load_torch_checkpoint, make_feat_ext, tf32_off
from ..device import resolve_device
from ..geometry.cameras import decompose_projection
from ..geometry.projections import scale_camera

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
FEAT_BATCH = 20   # views through the FeatExt at a time (ref :138-149)


def glob_imgs(path):
    out = []
    for ext in ("*.png", "*.jpg", "*.JPEG", "*.JPG"):
        out.extend(glob(os.path.join(path, ext)))
    return sorted(out)


def resize_bilinear(imgs: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size): bilinear at half-pixel centres with no
    antialiasing, the samples of ``cv2.resize(INTER_LINEAR)``."""
    return F.interpolate(imgs, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


def frozen_features(net, rgbs, size) -> torch.Tensor:
    """Head [2] of the frozen FeatExt ``net`` on images ``rgbs`` (a
    sequence of (3, H, W) float32 arrays in [-1, 1]): resized bilinearly to
    ``size`` (H', W') where they differ, ImageNet-normalised, on the net's
    device, FEAT_BATCH views at a time, TF32 off, through cuDNN's
    deterministic algorithms (the same bits in every run). Returns (N, 32,
    H'/2, W'/2) on that device."""
    dev = next(net.parameters()).device
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)[:, None, None]
    std = torch.from_numpy(IMAGENET_STD).to(dev)[:, None, None]
    out = None
    with torch.no_grad(), tf32_off(), deterministic_cudnn():
        for i in range(0, len(rgbs), FEAT_BATCH):
            x = torch.from_numpy(np.stack(rgbs[i:i + FEAT_BATCH])).to(dev)
            if x.shape[-2:] != tuple(size):
                x = resize_bilinear(x, size)
            f2 = net((x / 2 + 0.5 - mean) / std)[2]
            if out is None:
                out = torch.empty((len(rgbs),) + f2.shape[1:],
                                  dtype=f2.dtype, device=dev)
            out[i:i + f2.shape[0]] = f2
    return out


class SceneData:
    """Loads a full scene (numpy on the host, features on the device) and
    serves training batches."""

    def __init__(self, data_dir: str, num_src: int = 2,
                 feat_img_scale: int = 2, feat_params=None,
                 load_features: bool = True,
                 allow_random_features: bool = False, device=None):
        self.data_dir = data_dir
        self.device = resolve_device(device)
        self.allow_random_features = allow_random_features
        self.num_src = num_src  # top-2 source views (ref :104)
        self.feat_img_scale = feat_img_scale
        native = self.device.type == "cuda"
        self.timings = {}
        t_load = time.perf_counter()

        image_paths = glob_imgs(os.path.join(data_dir, "image_hd"))
        mask_paths = glob_imgs(os.path.join(data_dir, "mask_hd"))
        self.n_images = len(image_paths)
        if self.n_images == 0:
            raise FileNotFoundError(f"no images under {data_dir}/image_hd")

        cam_file = os.path.join(data_dir, "cameras_hd.npz")
        cams = np.load(cam_file)
        self.scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32)
                           for i in range(self.n_images)]
        self.world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                           for i in range(self.n_images)]
        self.intrinsics = np.zeros((self.n_images, 4, 4), np.float32)
        self.poses = np.zeros((self.n_images, 4, 4), np.float32)
        for i, (w, s) in enumerate(zip(self.world_mats, self.scale_mats)):
            intr, pose = decompose_projection((w @ s)[:3, :4])
            self.intrinsics[i] = intr
            self.poses[i] = pose

        # noisy linear-method pose initializations for camera optimization
        # (ref get_pose_init, scene_dataset.py:270-287); GT poses otherwise
        lin_file = os.path.join(data_dir, "cameras_linear_init.npz")
        if os.path.exists(lin_file):
            lin = np.load(lin_file)
            self.pose_init = np.zeros((self.n_images, 4, 4), np.float32)
            for i in range(self.n_images):
                P = (lin[f"world_mat_{i}"].astype(np.float32)
                     @ lin[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
                _, self.pose_init[i] = decompose_projection(P)
        else:
            self.pose_init = self.poses

        t0 = time.perf_counter()
        rgbs = [formats.load_rgb(p, native) for p in image_paths]
        masks = [formats.load_mask(p, native).reshape(-1)
                 for p in mask_paths]
        self.timings["png_decode_s"] = time.perf_counter() - t0
        self.timings["png_files"] = len(rgbs) + len(masks)
        self.img_res = rgbs[0].shape[1:]
        H, W = self.img_res
        self.total_pixels = H * W
        self.rgb = np.stack([r.reshape(3, -1).T for r in rgbs])  # (N, HW, 3)
        self.masks = np.stack(masks)  # (N, HW)

        pmask_dir = os.path.join(data_dir, "pmask")
        self.perfect_masks = None
        if os.path.isdir(pmask_dir):
            self.perfect_masks = np.stack(
                [formats.load_mask(p, native).reshape(-1)
                 for p in glob_imgs(pmask_dir)])

        # --- MVS side -----------------------------------------------------
        self.pair = formats.load_pair(os.path.join(data_dir, "..",
                                                   "pair.txt"))
        self.depths = np.stack([
            formats.load_pfm(os.path.join(data_dir, "depth", f"{i:03}.pfm"))
            for i in range(self.n_images)])[:, None]  # (N, 1, h, w)
        self.depth_cams = np.stack([
            formats.load_cam(os.path.join(
                data_dir, "..",
                f"cam_{self.pair['id_list'][i].zfill(8)}_flow3.txt"),
                max_d=256, interval_scale=1)
            for i in range(self.n_images)]).astype(np.float32)
        self.cams_hd = np.stack([
            scale_camera(self.depth_cams[i], feat_img_scale)
            for i in range(self.n_images)]).astype(np.float32)

        # scene normalization (ref :130-131)
        self.size = np.float32(self.scale_mats[0][0, 0] * 2)
        self.center = self.scale_mats[0][:3, 3].astype(np.float32)

        # pixel-center uv grid, x-major like the reference (ref :134-136)
        uv = np.mgrid[0:H, 0:W].astype(np.int32)
        self.uv = np.flip(uv, axis=0).reshape(2, -1).T.astype(np.float32)

        # --- frozen CNN features ------------------------------------------
        self.feats: Optional[torch.Tensor] = None
        if load_features:
            self.feats = self._compute_features(rgbs, feat_params)
        self.timings["load_s"] = time.perf_counter() - t_load

        self.sampling_idx: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _feat_state(self, feat_params):
        if feat_params is not None:
            return feat_params
        weights_path = os.environ.get("MVSDF_VISMVSNET_PT", "")
        if weights_path and os.path.exists(weights_path):
            return load_torch_checkpoint(weights_path)
        if self.allow_random_features:
            # Explicit opt-in only (synthetic fixtures / bring-up): on real
            # imagery the feature-consistency loss would supervise against
            # CNN noise instead of the pretrained VisMVSNet features the
            # reference loads (ref my_utils.py:688-708).
            warnings.warn(
                "FeatExt: using RANDOM CNN weights "
                "(allow_random_features=True). Feature-consistency "
                "supervision is meaningless on real scenes without the "
                "pretrained VisMVSNet checkpoint.", stacklevel=3)
            return init_feat_ext(np.random.default_rng(0))
        raise FileNotFoundError(
            "Pretrained FeatExt weights not found. Point "
            "MVSDF_VISMVSNET_PT at the VisMVSNet checkpoint "
            "(vismvsnet.pt from the MVSDF release — see the reference "
            "README.md:32, HuggingFace jzhangbs/mvsdf), or pass "
            "allow_random_features=True to accept random features "
            "(synthetic/bring-up scenes only).")

    def _compute_features(self, rgbs, feat_params) -> torch.Tensor:
        """``frozen_features`` of the images at feat_img_scale x the depth
        maps' size (ref scene_dataset.py:117-149). feat_params: a FeatExt
        state dict (reference key names)."""
        net = make_feat_ext(self._feat_state(feat_params), self.device)
        h, w = self.depths.shape[-2:]
        t0 = time.perf_counter()
        out = frozen_features(net, rgbs, (h * self.feat_img_scale,
                                          w * self.feat_img_scale))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["featext_s"] = time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    def get_scale_mat(self) -> np.ndarray:
        """The unit-sphere -> world map of the scene (view 0's scale_mat)."""
        return self.scale_mats[0]

    def get_gt_pose(self, scaled: bool = False) -> np.ndarray:
        """(n, 4, 4) camera-to-world poses decomposed from the world
        matrices, without the unit-sphere normalisation unless ``scaled``
        (ref scene_dataset.py:253-268): the ground truth that optimised
        cameras are compared with under --eval_cameras."""
        poses = np.zeros((self.n_images, 4, 4), np.float32)
        for i, (w, s) in enumerate(zip(self.world_mats, self.scale_mats)):
            P = (w @ s) if scaled else w
            _, poses[i] = decompose_projection(P[:3, :4])
        return poses

    def draw_sampling_idx(self, n: int, rng: np.random.Generator):
        """One epoch's random pixel subset shared by all images (ref
        :244-248), or None for every pixel (n == -1); reads nothing of the
        scene but its pixel count, so the trainer's draw-ahead thread may
        call it."""
        if n == -1:
            return None
        return rng.permutation(self.total_pixels)[:n].copy()

    def change_sampling_idx(self, n: int, rng: np.random.Generator):
        """Draw the next epoch's pixel subset into ``sampling_idx``."""
        self.sampling_idx = self.draw_sampling_idx(n, rng)

    def src_indices(self, idx: int):
        img_id = self.pair["id_list"][idx]
        src_ids = self.pair[img_id]["pair"][:self.num_src]
        return [self.pair[s]["index"] for s in src_ids]

    def get_batch(self, indices):
        """Assemble a (B, P) training batch dict of numpy arrays for the
        given image indices (ref __getitem__ + collate, :165-242); the
        features come to the host for it."""
        sel = (np.arange(self.total_pixels) if self.sampling_idx is None
               else self.sampling_idx)
        B = len(indices)
        batch = {
            "indices": np.asarray(list(indices), np.int32),
            "uv": np.stack([self.uv[sel] for _ in indices]),
            "intrinsics": self.intrinsics[list(indices)],
            "pose": self.poses[list(indices)],
            "object_mask": np.stack([self.masks[i][sel] for i in indices]),
            "rgb": np.stack([self.rgb[i][sel] for i in indices]),
            # each image contributes its own reference-view depth map
            # (sel_depth_num=1, ref :132, :203-206)
            "depths": self.depths[list(indices)][:, None],
            "depth_cams": self.depth_cams[list(indices)][:, None],
            "size": np.full((B,), self.size, np.float32),
            "center": np.tile(self.center[None], (B, 1)),
        }
        if self.feats is not None:
            srcs = [self.src_indices(i) for i in indices]
            feats = lambda ids: self.feats[list(ids)].cpu().numpy()
            batch["feat"] = feats(indices)
            batch["feat_src"] = np.stack([feats(s) for s in srcs])
            batch["cam"] = self.cams_hd[list(indices)]
            batch["src_cams"] = np.stack([self.cams_hd[s] for s in srcs])
        return batch
