"""Seeded procedural LiDAR scans, rendered on the device.

A frozen copy of the port's generator (``data/procedural.py``): street-like
scenes (ground, yawed boxes, poles, optional terrain and clutter) ray-cast
with a spinning 64-ring-like fan from a sensor moving ~``step`` m a frame,
then voxel-downsampled. The scene and the trajectory are drawn on the host
from ``numpy.random.default_rng(seed)``; the rays are cast in float64 on
the device and the range noise drawn there from a ``torch.Generator``; the
voxel grid is averaged on the host. The same seed gives the same scans on
the same kind of device."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

SENSOR_HEIGHT = 1.73  # KITTI velodyne mount height above ground (m)


class Scene(NamedTuple):
    boxes: np.ndarray       # (K, 6) cx, cy, yaw, half_w, half_d, height
    cylinders: np.ndarray   # (M, 4) cx, cy, radius, height
    terrain: Optional[np.ndarray]  # (4, O) amp, kx, ky, phase or None
    centerline: np.ndarray  # (3,) amplitude, wavenumber, phase (zeros: straight)


def _center_y(c, x):
    return c[0] * np.sin(c[1] * x + c[2])


def _center_heading(c, x):
    return np.arctan(c[0] * c[1] * np.cos(c[1] * x + c[2]))


def make_scene(rng: np.random.Generator, length: float, enrich: bool,
               half_width: float = 6.0, n_boxes: int = 14, n_cylinders: int = 24,
               n_clutter: int = 16) -> Scene:
    boxes = np.zeros((n_boxes, 6))
    for i in range(n_boxes):
        hw, hd = rng.uniform(2.5, 10.0), rng.uniform(2.5, 10.0)
        cx = rng.uniform(-20.0, length + 20.0)
        clear = half_width + max(hw, hd)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(clear, clear + 30.0)
        boxes[i] = [cx, cy, rng.uniform(0, np.pi), hw, hd, rng.uniform(3.0, 12.0)]
    cyls = np.zeros((n_cylinders, 4))
    for i in range(n_cylinders):
        cx = rng.uniform(-20.0, length + 20.0)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(half_width - 2.0, half_width + 14.0)
        cyls[i] = [cx, cy, rng.uniform(0.12, 0.45), rng.uniform(2.5, 8.0)]
    if not enrich:
        return Scene(boxes, cyls, None, np.zeros(3))
    center = np.array([rng.uniform(4.0, 10.0), 2.0 * np.pi / rng.uniform(90.0, 150.0),
                       rng.uniform(0, 2 * np.pi)])
    boxes[:, 1] += _center_y(center, boxes[:, 0])
    cyls[:, 1] += _center_y(center, cyls[:, 0])
    octaves = []
    for wl, amp in ((90.0, 0.65), (45.0, 0.32), (18.0, 0.13)):
        theta = rng.uniform(0, 2 * np.pi)
        k = 2.0 * np.pi / (wl * rng.uniform(0.8, 1.25))
        octaves.append((rng.uniform(0.45, 1.0) * amp, k * np.cos(theta), k * np.sin(theta),
                        rng.uniform(0, 2 * np.pi)))
    clutter = np.zeros((n_clutter, 6))
    for i in range(n_clutter):
        cx = rng.uniform(-10.0, length + 10.0)
        lat = rng.choice([-1.0, 1.0]) * rng.uniform(3.4, half_width - 0.4)
        yaw = _center_heading(center, cx) + np.deg2rad(rng.uniform(-8.0, 8.0))
        clutter[i] = [cx, _center_y(center, cx) + lat, yaw, rng.uniform(0.7, 2.3),
                      rng.uniform(0.45, 1.0), rng.uniform(0.8, 2.0)]
    return Scene(np.concatenate([boxes, clutter]), cyls, np.array(octaves).T, center)


def _euler_zyx(yaw, pitch, roll) -> np.ndarray:
    cz, sz, cy, sy, cx, sx = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rz @ ry @ rx


def _ground_z(scene: Scene, x, y):
    if scene.terrain is None:
        return 0.0
    amp, kx, ky, ph = scene.terrain
    return float(np.sum(amp * np.sin(kx * x + ky * y + ph)))


def trajectory(rng: np.random.Generator, scene: Scene, n_frames: int, step: float) -> np.ndarray:
    """(n_frames, 4, 4) world-from-sensor poses ~``step`` m apart with small
    drift in all six degrees of freedom."""
    poses = np.zeros((n_frames, 4, 4))
    for k in range(n_frames):
        x = k * step + rng.uniform(-1.0, 1.0)
        y = rng.uniform(-2.0, 2.0) + _center_y(scene.centerline, x)
        yaw = np.deg2rad(rng.uniform(-8.0, 8.0)) + _center_heading(scene.centerline, x)
        pitch, roll = np.deg2rad(rng.uniform(-1.5, 1.5)), np.deg2rad(rng.uniform(-1.5, 1.5))
        z = SENSOR_HEIGHT + rng.uniform(-0.05, 0.05) + _ground_z(scene, x, y)
        poses[k] = np.eye(4)
        poses[k, :3, :3] = _euler_zyx(yaw, pitch, roll)
        poses[k, :3, 3] = [x, y, z]
    return poses


def _ray_dirs(n_rings: int, n_azimuths: int, device) -> torch.Tensor:
    """HDL-64-like elevation fan (-24.8 .. +2 deg) x a full azimuth sweep."""
    elev = torch.deg2rad(torch.linspace(-24.8, 2.0, n_rings, dtype=torch.float64, device=device))
    az = torch.arange(n_azimuths, dtype=torch.float64, device=device) * (2 * np.pi / n_azimuths)
    e, a = torch.meshgrid(elev, az, indexing="ij")
    return torch.stack([torch.cos(e) * torch.cos(a), torch.cos(e) * torch.sin(a),
                        torch.sin(e)], -1).reshape(-1, 3)


def _hit_boxes(o, d, boxes, z_lo):
    t_best = torch.full((d.shape[0],), float("inf"), dtype=d.dtype, device=d.device)
    for cx, cy, yaw, hw, hd, h in boxes:
        c, s = np.cos(yaw), np.sin(yaw)
        rot = torch.tensor([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], dtype=d.dtype,
                           device=d.device)
        ol = rot @ (o - torch.tensor([cx, cy, 0.0], dtype=d.dtype, device=d.device))
        dl = d @ rot.T
        dl = torch.where(dl.abs() < 1e-12, torch.full_like(dl, 1e-12), dl)
        lo = torch.tensor([-hw, -hd, z_lo], dtype=d.dtype, device=d.device)
        hi = torch.tensor([hw, hd, h], dtype=d.dtype, device=d.device)
        t1, t2 = (lo - ol) / dl, (hi - ol) / dl
        near = torch.minimum(t1, t2).amax(1)
        far = torch.maximum(t1, t2).amin(1)
        hit = (near <= far) & (near > 0.1)
        t_best = torch.where(hit, torch.minimum(t_best, near), t_best)
    return t_best


def _hit_cylinders(o, d, cyls, z_lo):
    c = torch.as_tensor(cyls, dtype=d.dtype, device=d.device)
    ox, oy = o[0] - c[:, 0], o[1] - c[:, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    b = 2.0 * (ox * dx + oy * dy)
    cc = ox * ox + oy * oy - c[:, 2] ** 2
    disc = b * b - 4.0 * a * cc
    t = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (2.0 * a)
    z = o[2] + t * dz
    ok = (disc >= 0) & (t > 0.1) & (z >= z_lo) & (z <= c[:, 3])
    return torch.where(ok, t, torch.full_like(t, float("inf"))).amin(1)


def _hit_ground(o, d, scene: Scene, max_range: float):
    if scene.terrain is None:
        down = d[:, 2] < -1e-9
        return torch.where(down, -o[2] / torch.where(down, d[:, 2], -torch.ones_like(d[:, 2])),
                           torch.full_like(d[:, 2], float("inf")))
    amp, kx, ky, ph = (torch.as_tensor(v, dtype=d.dtype, device=d.device) for v in scene.terrain)

    def height(x, y):
        return (amp * torch.sin(kx * x[..., None] + ky * y[..., None] + ph)).sum(-1)

    down = d[:, 2] < -0.005
    dz = torch.where(down, d[:, 2], -torch.ones_like(d[:, 2]))
    h0 = height(o[0].reshape(1), o[1].reshape(1))
    t = torch.clamp((h0 - o[2]) / dz, 0.2, 2.0 * max_range)
    for _ in range(12):
        t_new = torch.clamp((height(o[0] + t * d[:, 0], o[1] + t * d[:, 1]) - o[2]) / dz,
                            0.2, 2.0 * max_range)
        t = 0.5 * (t + t_new)
    resid = (o[2] + t * d[:, 2] - height(o[0] + t * d[:, 0], o[1] + t * d[:, 1])).abs()
    return torch.where(down & (resid < 0.05), t, torch.full_like(t, float("inf")))


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """(N, 4) xyzi -> each voxel's centroid and mean intensity, float32."""
    xyz = points[:, :3]
    origin = np.floor(xyz.min(0) / voxel) * voxel
    coords = np.floor((xyz - origin) / voxel).astype(np.int64)
    order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))
    sc, sp = coords[order], points[order]
    new = np.concatenate([[True], np.any(sc[1:] != sc[:-1], axis=1)])
    seg = np.cumsum(new) - 1
    sums = np.zeros((seg[-1] + 1, points.shape[1]))
    np.add.at(sums, seg, sp)
    return (sums / np.bincount(seg)[:, None]).astype(np.float32)


def lidar_scan(scene: Scene, pose: np.ndarray, gen: torch.Generator, device, n_rings: int,
               n_azimuths: int, max_range: float = 80.0, range_noise: float = 0.02,
               voxel: float = 0.3) -> np.ndarray:
    """One scan from a world-from-sensor pose: (N, 4) xyzi float32 in the
    sensor frame, voxel-downsampled."""
    rot = torch.as_tensor(pose[:3, :3], device=device)
    org = torch.as_tensor(pose[:3, 3], device=device)
    d = _ray_dirs(n_rings, n_azimuths, device) @ rot.T
    z_lo = -2.5 if scene.terrain is not None else 0.0
    t = torch.minimum(_hit_ground(org, d, scene, max_range), _hit_boxes(org, d, scene.boxes, z_lo))
    t = torch.minimum(t, _hit_cylinders(org, d, scene.cylinders, z_lo))
    hit = torch.isfinite(t) & (t < max_range)
    noise = torch.randn(t.shape, generator=gen, device=device, dtype=torch.float64)
    t = t + noise * range_noise
    world = org + t[:, None] * d
    sensor = (world - org) @ rot
    inten = 1.0 / (1.0 + t / 20.0)
    scan = torch.cat([sensor, inten[:, None]], 1)[hit].float().cpu().numpy()
    return voxel_downsample(scan, voxel)


def sequence(seed: int, n_frames: int, n_rings: int, n_azimuths: int, step: float,
             enrich: bool, device) -> Tuple[List[np.ndarray], np.ndarray]:
    """(scans, poses) of one seeded scene; frame j aligns onto frame i by
    ``inv(poses[i]) @ poses[j]``."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 1]))
    scene = make_scene(rng, max(60.0, n_frames * step + 30.0), enrich)
    poses = trajectory(rng, scene, n_frames, step)
    gen = torch.Generator(device).manual_seed(int(rng.integers(1 << 62)))
    scans = [lidar_scan(scene, poses[k], gen, device, n_rings, n_azimuths) for k in range(n_frames)]
    return scans, poses


def pair_pool(seed: int, n_sequences: int, n_frames: int, n_rings: int, n_azimuths: int,
              step: float, enrich: bool, device) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Consecutive-frame pairs of ``n_sequences`` seeded sequences: [(ref
    (N, 3), src (M, 3), transform (4, 4) src -> ref)] float32."""
    pairs = []
    for i in range(n_sequences):
        scans, poses = sequence(seed * 1000 + i, n_frames, n_rings, n_azimuths, step, enrich,
                                device)
        for j in range(n_frames - 1):
            tf = np.linalg.inv(poses[j]) @ poses[j + 1]
            pairs.append((scans[j][:, :3].copy(), scans[j + 1][:, :3].copy(),
                          tf.astype(np.float32)))
    return pairs
