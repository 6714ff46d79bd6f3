"""nuScenes data layer (counterpart of ``data/nuscenes.py``): a reader of
the v1.0 JSON tables and the per-frame sample assembly.

Stands in for three reference components without the devkit, mmdet3d or
pyquaternion:
  * the info-pkl conversion (ref:nuscenes_converter.py:43-303) —
    :class:`NuScenesIndex`, built from the JSON tables;
  * NuScenesDatasetM (ref:nuscenes_dataset.py:109-245) — per-frame dicts
    with the 6 cameras' 4x4 transforms and the scene's metadata;
  * the mm-pipeline ops the configs name (``LoadMultiViewImageFromFiles``,
    ``ImageAug3D``, ``ImageNormalize``, ``ObjectNameFilterM``,
    ``ReorderMultiViewImagesM``) — fused into :class:`NuScenesDataset`
    (ref:configs/dataset/Nuscenes.yaml:94-180).

Samples follow the contract of :mod:`magicdrive_tpu_torch.data.collate`
(NHWC images in [-1, 1], 7-dim lidar-frame boxes with origin
(0.5, 0.5, 0), 4x4 transform stacks).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from .bbox import corners_from_boxes

# raw category -> training name (mmdet3d NuScenesDataset.NameMapping subset
# used by the 10 object_classes, ref:configs/dataset/Nuscenes.yaml:63-74)
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

OBJECT_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

# converter camera order (ref:nuscenes_converter.py:233-240); view_order
# reordering happens at sample assembly (ReorderMultiViewImagesM semantics)
ORI_CAMERA_ORDER = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
VIEW_ORDER = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
              "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT")


def quat_to_rot(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_inv(q):
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


def quat_yaw(q) -> float:
    """Yaw of a quaternion (pyquaternion yaw_pitch_roll[0] convention)."""
    w, x, y, z = q
    return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))


def make_se3(rotation_q, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(rotation_q)
    m[:3, 3] = translation
    return m


class NuScenesTables:
    """Raw v1.0 JSON tables with token indices."""

    TABLE_NAMES = ("sample", "sample_data", "calibrated_sensor", "ego_pose",
                   "scene", "log", "sample_annotation", "category")

    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        base = os.path.join(dataroot, version)
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in self.TABLE_NAMES:
            with open(os.path.join(base, f"{name}.json")) as f:
                recs = json.load(f)
            self._tables[name] = recs
            self._index[name] = {r["token"]: r for r in recs}

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def table(self, table: str) -> List[dict]:
        return self._tables[table]


@dataclasses.dataclass
class FrameInfo:
    """Converter-equivalent per-keyframe record (ref:nuscenes_converter.py
    info dict). All transforms are 4x4 float64; boxes are SECOND-format
    (x, y, z_gravity, w, l, h, yaw) in the lidar frame with the bevfusion
    origin-(0.5,0.5,0) declaration (ref:nuscenes_dataset.py:232-240)."""

    token: str
    location: str
    description: str
    timeofday: str
    timestamp: int
    ego2global: np.ndarray
    lidar2ego: np.ndarray
    image_paths: List[str]
    camera_intrinsics: np.ndarray   # (6, 4, 4)
    camera2lidar: np.ndarray        # (6, 4, 4)
    lidar2camera: np.ndarray        # (6, 4, 4)
    lidar2image: np.ndarray         # (6, 4, 4)
    camera2ego: np.ndarray          # (6, 4, 4)
    gt_boxes: np.ndarray            # (N, 7)
    gt_labels: np.ndarray           # (N,) int, -1 for unmapped
    gt_velocity: np.ndarray         # (N, 2) lidar-frame
    num_lidar_pts: np.ndarray       # (N,)
    visibility: np.ndarray          # (N,) uint8 (1-4)

    @property
    def lidar2global(self) -> np.ndarray:
        return self.ego2global @ self.lidar2ego


class NuScenesIndex:
    """Builds per-sample FrameInfo records + train/val scene split.

    Equivalent to ``create_nuscenes_infos`` without the pkl intermediary;
    results can still be pickled via :meth:`save` for fast reload.
    """

    def __init__(self, dataroot: str, version: str = "v1.0-trainval",
                 classes: Sequence[str] = OBJECT_CLASSES,
                 camera_order: Sequence[str] = ORI_CAMERA_ORDER):
        self.dataroot = dataroot
        self.classes = tuple(classes)
        self.camera_order = tuple(camera_order)
        t = NuScenesTables(dataroot, version)
        self._build_sample_data_index(t)
        self.infos: List[FrameInfo] = []
        self.scene_of: List[str] = []
        for sample in t.table("sample"):
            self.infos.append(self._build_frame(t, sample))
            self.scene_of.append(sample["scene_token"])
        self.scene_names = {
            s["token"]: s["name"] for s in t.table("scene")}

    def _build_sample_data_index(self, t: NuScenesTables) -> None:
        """sample token -> {channel: keyframe sample_data token} (the devkit
        derives sample['data'] the same way; channel resolved via sensor.json
        when present, else parsed from the filename)."""
        sensor_channel = {}
        sensor_path = os.path.join(t.dataroot, t.version, "sensor.json")
        if os.path.isfile(sensor_path):
            with open(sensor_path) as f:
                sensors = json.load(f)
            chan_of_sensor = {s["token"]: s["channel"] for s in sensors}
            for cs in t.table("calibrated_sensor"):
                if "sensor_token" in cs:
                    sensor_channel[cs["token"]] = chan_of_sensor.get(
                        cs["sensor_token"])
        channels = set(ORI_CAMERA_ORDER) | {"LIDAR_TOP"}
        by_len = sorted(channels, key=len, reverse=True)  # longest match first
        self.sample_data: Dict[str, Dict[str, str]] = {}
        for sd in t.table("sample_data"):
            if not sd.get("is_key_frame", True):
                continue
            chan = sensor_channel.get(sd.get("calibrated_sensor_token"))
            if chan is None:
                chan = next((c for c in by_len if c in sd["filename"]), None)
            if chan in channels:
                self.sample_data.setdefault(
                    sd["sample_token"], {})[chan] = sd["token"]

    def _build_frame(self, t: NuScenesTables, sample: dict) -> FrameInfo:
        data = self.sample_data[sample["token"]]
        lidar_sd = t.get("sample_data", data["LIDAR_TOP"])
        cs = t.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        pose = t.get("ego_pose", lidar_sd["ego_pose_token"])
        scene = t.get("scene", sample["scene_token"])
        log = t.get("log", scene["log_token"])

        lidar2ego = make_se3(cs["rotation"], cs["translation"])
        ego2global = make_se3(pose["rotation"], pose["translation"])
        q_l2e, t_l2e = np.asarray(cs["rotation"]), np.asarray(cs["translation"])
        q_e2g, t_e2g = np.asarray(pose["rotation"]), np.asarray(
            pose["translation"])
        R_l2e, R_e2g = lidar2ego[:3, :3], ego2global[:3, :3]

        # ---- cameras (obtain_sensor2top math, ref:nuscenes_converter.py) ----
        paths, Ks, c2ls, l2cs, l2is, c2es = [], [], [], [], [], []
        for cam in self.camera_order:
            sd = t.get("sample_data", data[cam])
            ccs = t.get("calibrated_sensor", sd["calibrated_sensor_token"])
            cpose = t.get("ego_pose", sd["ego_pose_token"])
            paths.append(os.path.join(self.dataroot, sd["filename"]))
            cam2ego = make_se3(ccs["rotation"], ccs["translation"])
            camego2global = make_se3(cpose["rotation"], cpose["translation"])
            # sensor -> global -> (keyframe) ego -> lidar
            cam2global = camego2global @ cam2ego
            global2lidar = np.linalg.inv(ego2global @ lidar2ego)
            cam2lidar = global2lidar @ cam2global
            K = np.eye(4)
            K[:3, :3] = np.asarray(ccs["camera_intrinsic"])
            lidar2cam = np.linalg.inv(cam2lidar)
            Ks.append(K)
            c2ls.append(cam2lidar)
            l2cs.append(lidar2cam)
            l2is.append(K @ lidar2cam)
            c2es.append(cam2ego)

        # ---- annotations -> lidar-frame SECOND boxes ----
        anns = [t.get("sample_annotation", tok) for tok in sample["anns"]]
        n = len(anns)
        boxes = np.zeros((n, 7))
        labels = np.full((n,), -1, np.int64)
        vel = np.zeros((n, 2))
        npts = np.zeros((n,), np.int64)
        vis = np.zeros((n,), np.uint8)
        q_lg_inv = quat_inv(quat_mul(q_e2g, q_l2e))
        for i, a in enumerate(anns):
            c_global = np.asarray(a["translation"])
            c_lidar = R_l2e.T @ (R_e2g.T @ (c_global - t_e2g) - t_l2e)
            q_box = quat_mul(q_lg_inv, np.asarray(a["rotation"]))
            yaw = quat_yaw(q_box)
            w, l, h = a["size"]
            boxes[i] = [*c_lidar, w, l, h, -yaw - np.pi / 2]
            name = t.get("category", a["category_token"])["name"] if \
                "category_token" in a else a["category_name"]
            mapped = NAME_MAPPING.get(name)
            if mapped in self.classes:
                labels[i] = self.classes.index(mapped)
            npts[i] = a.get("num_lidar_pts", 0)
            v_tok = a.get("visibility_token", "0")
            vis[i] = int(v_tok) if str(v_tok).isdigit() else 0
            # global->lidar velocity rotation (ref:nuscenes_converter.py:287-290)
            v3 = self._box_velocity(t, a)
            vel[i] = (v3 @ R_e2g @ R_l2e)[:2]

        return FrameInfo(
            token=sample["token"], location=log["location"],
            description=scene["description"],
            timeofday=log["logfile"][5:] if log.get("logfile") else "",
            timestamp=sample["timestamp"], ego2global=ego2global,
            lidar2ego=lidar2ego, image_paths=paths,
            camera_intrinsics=np.stack(Ks), camera2lidar=np.stack(c2ls),
            lidar2camera=np.stack(l2cs), lidar2image=np.stack(l2is),
            camera2ego=np.stack(c2es), gt_boxes=boxes, gt_labels=labels,
            gt_velocity=vel, num_lidar_pts=npts, visibility=vis)

    @staticmethod
    def _box_velocity(t: NuScenesTables, ann: dict,
                      max_time_diff: float = 1.5) -> np.ndarray:
        """Finite-difference global-frame velocity (devkit box_velocity)."""
        has_prev, has_next = bool(ann.get("prev")), bool(ann.get("next"))
        if not has_prev and not has_next:
            return np.zeros(3)
        first = t.get("sample_annotation", ann["prev"]) if has_prev else ann
        last = t.get("sample_annotation", ann["next"]) if has_next else ann
        pos_diff = (np.asarray(last["translation"])
                    - np.asarray(first["translation"]))
        t0 = t.get("sample", first["sample_token"])["timestamp"] / 1e6
        t1 = t.get("sample", last["sample_token"])["timestamp"] / 1e6
        dt = t1 - t0
        if dt <= 0 or dt > 2 * max_time_diff:
            return np.zeros(3)
        return pos_diff / dt

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"infos": self.infos, "scene_of": self.scene_of,
                         "scene_names": self.scene_names,
                         "classes": self.classes}, f)

    @classmethod
    def load(cls, path: str) -> "NuScenesIndex":
        obj = cls.__new__(cls)
        with open(path, "rb") as f:
            d = pickle.load(f)
        obj.infos = d["infos"]
        obj.scene_of = d["scene_of"]
        obj.scene_names = d["scene_names"]
        obj.classes = d["classes"]
        obj.dataroot = None
        obj.camera_order = ORI_CAMERA_ORDER
        return obj


# ---------------------------------------------------------------------------
# image loading / augmentation (ImageAug3D + ImageNormalize semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImageAugConfig:
    """bevfusion ImageAug3D with the released settings: deterministic
    resize-to-ratio + top crop, no flip/rotation
    (ref:configs/dataset/Nuscenes.yaml:101-110)."""

    final_hw: Tuple[int, int] = (224, 400)
    resize_lim: Tuple[float, float] = (0.25, 0.25)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    rand_flip: bool = False
    is_train: bool = False  # reference trains with is_train=false here too

    def params(self, src_hw: Tuple[int, int],
               rng: Optional[np.random.Generator] = None):
        H, W = src_hw
        fH, fW = self.final_hw
        if self.is_train and rng is not None:
            resize = rng.uniform(*self.resize_lim)
            bot = rng.uniform(*self.bot_pct_lim)
        else:
            resize = float(np.mean(self.resize_lim))
            bot = float(np.mean(self.bot_pct_lim))
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - bot) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        return resize, crop


def load_and_aug_image(path_or_img, aug: ImageAugConfig,
                       rng: Optional[np.random.Generator] = None):
    """-> (img (H, W, 3) float32 in [-1, 1], img_aug_matrix (4, 4)).

    JPEG files are decoded with PIL ``draft`` (DCT-domain 1/2-1/8
    downscaling): at the released resize ratios (0.25 of 1600x900,
    ref:configs/dataset/Nuscenes.yaml:101-110) the decoder emits the target
    size directly, far cheaper than a full decode and resize. The
    ``resize`` that follows is a no-op when the draft lands exactly;
    otherwise it finishes from the drafted scale.
    """
    if isinstance(path_or_img, str):
        img = Image.open(path_or_img)
        W, H = img.size
        resize, crop = aug.params((H, W), rng)
        if img.format == "JPEG":
            img.draft("RGB", (max(1, int(W * resize)),
                              max(1, int(H * resize))))
        img = img.convert("RGB")
    else:
        img = path_or_img
        W, H = img.size
        resize, crop = aug.params((H, W), rng)
    target = (int(W * resize), int(H * resize))
    if img.size != target:
        img = img.resize(target)
    img = img.crop(crop)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - 0.5) / 0.5  # ImageNormalize mean/std 0.5
    mat = np.eye(4)
    mat[:2, :2] *= resize
    mat[:2, 3] = [-crop[0], -crop[1]]
    return arr, mat


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


class NuScenesDataset:
    """Per-frame sample dicts in the collate contract.

    Fuses the reference's mm-pipeline: image load + ImageAug3D + normalize,
    ObjectNameFilterM (drop label -1), the BEV map (rasterized, or read
    from a ``cache.BEVCache``), ReorderMultiViewImagesM (converter order ->
    view_order), metas assembly.

    ``transforms_3d`` run on the sample dict before the BEV map is made
    (the reference's order for GlobalRotScaleTrans,
    ref:configs/dataset/Nuscenes.yaml:112-121); ``transforms`` run after it
    (RandomFlip3DwithViews, which flips the finished map,
    ref:configs/dataset/Nuscenes.yaml:130-132).
    """

    def __init__(self, index: NuScenesIndex, rasterizer=None, cache=None,
                 view_order: Sequence[str] = VIEW_ORDER,
                 aug: ImageAugConfig = ImageAugConfig(),
                 with_images: bool = True,
                 force_all_boxes: bool = True,
                 sample_indices: Optional[Sequence[int]] = None,
                 transforms_3d: Sequence = (),
                 transforms: Sequence = (),
                 seed: int = 0):
        self.index = index
        self.rasterizer = rasterizer
        self.cache = cache
        self.aug = aug
        self.with_images = with_images
        self.force_all_boxes = force_all_boxes
        self.order = [list(index.camera_order).index(c) for c in view_order]
        self.ids = list(sample_indices) if sample_indices is not None else \
            list(range(len(index.infos)))
        self.transforms_3d = list(transforms_3d)
        self.transforms = list(transforms)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ids)

    def filenames(self, i: int) -> List[str]:
        """Sample ``i``'s image paths in the view order, as its
        ``metas["filename"]``, without loading the sample."""
        info = self.index.infos[self.ids[i]]
        return [info.image_paths[j] for j in self.order]

    def __getitem__(self, i: int) -> dict:
        info = self.index.infos[self.ids[i]]
        o = self.order

        keep = np.ones(len(info.gt_boxes), bool) if self.force_all_boxes \
            else info.num_lidar_pts > 0
        keep &= info.gt_labels >= 0  # ObjectNameFilterM
        boxes = info.gt_boxes[keep]
        labels = info.gt_labels[keep]
        vis = info.visibility[keep]

        sample = {
            "boxes": boxes, "labels": labels, "visibility": vis,
            "camera_intrinsics": info.camera_intrinsics[o],
            "camera2lidar": info.camera2lidar[o],
            "lidar2camera": info.lidar2camera[o],
            "lidar2image": info.lidar2image[o],
            "camera2ego": info.camera2ego[o],
            "metas": {
                "location": info.location,
                "description": info.description,
                "timeofday": info.timeofday,
                "token": info.token,
                "filename": self.filenames(i),
            },
        }

        if self.with_images:
            imgs, mats = [], []
            for j in o:
                img, mat = load_and_aug_image(info.image_paths[j], self.aug,
                                              self.rng)
                imgs.append(img)
                mats.append(mat)
            sample["img"] = np.stack(imgs)
            sample["img_aug_matrix"] = np.stack(mats)
        else:
            sample["img_aug_matrix"] = np.stack([np.eye(4)] * len(o))

        for t in self.transforms_3d:
            sample = t(sample)
        sample["bev_map"] = self._bev_map(info, sample)
        for t in self.transforms:
            sample = t(sample)
        return sample

    def _bev_map(self, info: FrameInfo, sample: dict) -> np.ndarray:
        """(H, W, C) float32 BEV map, channel-last: the cache's where it
        holds the frame and no 3D augmentation moved it, else rasterized."""
        aug = np.asarray(sample.get("lidar_aug_matrix", np.eye(4)))
        aug_is_identity = np.allclose(aug, np.eye(4))
        if self.cache is not None and aug_is_identity:
            m = self.cache.get(info.token)
            if m is not None:
                return np.ascontiguousarray(
                    m.transpose(1, 2, 0)).astype(np.float32)
        if self.rasterizer is None:
            raise RuntimeError(
                "no BEV source: provide a rasterizer or a cache")
        boxes, labels = sample["boxes"], sample["labels"]
        # the static layers land in the augmented frame:
        # lidar2global @ inv(lidar_aug_matrix) (ref:pipeline.py:249-253)
        lidar2global = info.lidar2global if aug_is_identity else \
            info.lidar2global @ np.linalg.inv(aug)
        corners = corners_from_boxes(boxes) if len(boxes) else \
            np.zeros((0, 8, 3))
        out = self.rasterizer(
            info.location, lidar2global, corners=corners, labels=labels,
            box_heights=boxes[:, 5] if len(boxes) else np.zeros((0,)),
            visibility=sample["visibility"].astype(np.float32))
        masks = out["gt_masks_bev"].astype(np.float32)
        if "gt_aux_bev" in out:
            masks = np.concatenate([masks, out["gt_aux_bev"]], axis=0)
        return np.ascontiguousarray(masks.transpose(1, 2, 0))


class ListSetWrapper:
    """Subset by explicit indices (ref:dataset_wrapper.py:9-18)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
