"""Procedural LiDAR scans (numpy twin of ``rdmnet_tpu/data/procedural.py``).

Urban-like scenes (ground plane or terrain, yawed boxes, poles, optional
in-corridor clutter) rendered by ray-casting a spinning-LiDAR pattern from a
moving sensor pose, so two frames differ in sampling and occlusion like real
scan pairs. Scans are (N, 4) xyzi float32 in the sensor frame, voxel
downsampled at 0.3 m. The same seed gives the same scans as the JAX
package's module.

Scene arrays are never shared or mutated: a Scene without clutter holds its
own empty arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from rdmnet_tpu_torch.data.preprocess import voxel_downsample_xyzi
from rdmnet_tpu_torch.utils.se3_np import euler_zyx_matrix

SENSOR_HEIGHT = 1.73  # KITTI velodyne mount height above ground (m)


class Terrain(NamedTuple):
    """Ground height h(x, y) = sum_i amp_i sin(kx_i x + ky_i y + phase_i)."""

    amp: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    phase: np.ndarray

    def height(self, x, y):
        x = np.asarray(x, np.float64)[..., None]
        y = np.asarray(y, np.float64)[..., None]
        return np.sum(self.amp * np.sin(self.kx * x + self.ky * y + self.phase), axis=-1)


def _centerline_y(params, x):
    a, k, phi = params
    return a * np.sin(k * np.asarray(x, np.float64) + phi)


def _centerline_heading(params, x):
    a, k, phi = params
    return np.arctan(a * k * np.cos(k * np.asarray(x, np.float64) + phi))


class Scene(NamedTuple):
    """boxes (K, 6) cx, cy, yaw, half_w, half_d, height; cylinders (M, 4)
    cx, cy, radius, height; clutter (C, 6) like boxes; optional terrain;
    centerline (A, k, phi) of the corridor curve (zeros = straight)."""

    boxes: np.ndarray
    cylinders: np.ndarray
    clutter: Optional[np.ndarray] = None
    terrain: Optional[Terrain] = None
    centerline: Optional[np.ndarray] = None

    def clutter_boxes(self) -> np.ndarray:
        return np.zeros((0, 6)) if self.clutter is None else self.clutter

    def centerline_params(self) -> np.ndarray:
        return np.zeros(3) if self.centerline is None else self.centerline

    def centerline_y(self, x):
        return _centerline_y(self.centerline_params(), x)

    def centerline_heading(self, x):
        return _centerline_heading(self.centerline_params(), x)

    def ground_z(self, x, y):
        if self.terrain is None:
            return np.zeros(np.broadcast(x, y).shape)
        return self.terrain.height(x, y)


def make_scene(rng: np.random.RandomState, corridor_length: float = 140.0,
               corridor_half_width: float = 6.0, n_boxes: int = 14, n_cylinders: int = 24,
               enrich: bool = False, n_clutter: int = 16) -> Scene:
    """Random street-like scene along a +x corridor (same draws, in the same
    order, as the JAX package's generator)."""
    boxes = np.zeros((n_boxes, 6), np.float64)
    for i in range(n_boxes):
        half_w = rng.uniform(2.5, 10.0)
        half_d = rng.uniform(2.5, 10.0)
        cx = rng.uniform(-20.0, corridor_length + 20.0)
        clearance = corridor_half_width + max(half_w, half_d)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(clearance, clearance + 30.0)
        boxes[i] = [cx, cy, rng.uniform(0, np.pi), half_w, half_d, rng.uniform(3.0, 12.0)]
    cyls = np.zeros((n_cylinders, 4), np.float64)
    for i in range(n_cylinders):
        cx = rng.uniform(-20.0, corridor_length + 20.0)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(corridor_half_width - 2.0,
                                                   corridor_half_width + 14.0)
        cyls[i] = [cx, cy, rng.uniform(0.12, 0.45), rng.uniform(2.5, 8.0)]
    if not enrich:
        return Scene(boxes=boxes, cylinders=cyls)

    amp = rng.uniform(4.0, 10.0)
    wavelength = rng.uniform(90.0, 150.0)
    centerline = np.array([amp, 2.0 * np.pi / wavelength, rng.uniform(0, 2 * np.pi)])
    boxes[:, 1] += _centerline_y(centerline, boxes[:, 0])
    cyls[:, 1] += _centerline_y(centerline, cyls[:, 0])

    octaves = []
    for wl, amp_hi in ((90.0, 0.65), (45.0, 0.32), (18.0, 0.13)):
        theta = rng.uniform(0, 2 * np.pi)
        k = 2.0 * np.pi / (wl * rng.uniform(0.8, 1.25))
        octaves.append((rng.uniform(0.45, 1.0) * amp_hi, k * np.cos(theta), k * np.sin(theta),
                        rng.uniform(0, 2 * np.pi)))
    terrain = Terrain(*(np.array(col) for col in zip(*octaves)))

    clutter = np.zeros((n_clutter, 6), np.float64)
    for i in range(n_clutter):
        cx = rng.uniform(-10.0, corridor_length + 10.0)
        lat = rng.choice([-1.0, 1.0]) * rng.uniform(3.4, corridor_half_width - 0.4)
        yaw = float(_centerline_heading(centerline, cx)) + np.deg2rad(rng.uniform(-8.0, 8.0))
        half_w = rng.uniform(0.45, 1.0)
        half_d = rng.uniform(0.7, 2.3)
        clutter[i] = [cx, float(_centerline_y(centerline, cx)) + lat, yaw, half_d, half_w,
                      rng.uniform(0.8, 2.0)]
    return Scene(boxes=boxes, cylinders=cyls, clutter=clutter, terrain=terrain,
                 centerline=centerline)


def trajectory(rng: np.random.RandomState, n_frames: int, step: float = 10.0,
               scene: Optional[Scene] = None) -> np.ndarray:
    """(n_frames, 4, 4) world-from-sensor poses ~``step`` m apart along the
    corridor with small drift in all six degrees of freedom."""
    poses = np.zeros((n_frames, 4, 4), np.float64)
    for k in range(n_frames):
        x = k * step + rng.uniform(-1.0, 1.0)
        y = rng.uniform(-2.0, 2.0)
        yaw = np.deg2rad(rng.uniform(-8.0, 8.0))
        pitch = np.deg2rad(rng.uniform(-1.5, 1.5))
        roll = np.deg2rad(rng.uniform(-1.5, 1.5))
        z = SENSOR_HEIGHT + rng.uniform(-0.05, 0.05)
        if scene is not None:
            y += float(scene.centerline_y(x))
            yaw += float(scene.centerline_heading(x))
            z += float(scene.ground_z(x, y))
        m = np.eye(4)
        m[:3, :3] = euler_zyx_matrix(yaw, pitch, roll)
        m[:3, 3] = [x, y, z]
        poses[k] = m
    return poses


def _ray_dirs(n_rings: int, n_azimuths: int) -> np.ndarray:
    """HDL-64-like elevation fan (-24.8 .. +2 deg) x full azimuth sweep."""
    elev = np.deg2rad(np.linspace(-24.8, 2.0, n_rings))
    az = np.linspace(0.0, 2.0 * np.pi, n_azimuths, endpoint=False)
    e, a = np.meshgrid(elev, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], axis=-1)
    return d.reshape(-1, 3)


def _intersect_boxes(o, d, boxes, z_lo=0.0):
    t_best = np.full(len(d), np.inf)
    for cx, cy, yaw, hw, hd, h in boxes:
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        ol = rot @ (o - np.array([cx, cy, 0.0]))
        dl = d @ rot.T
        lo = np.array([-hw, -hd, z_lo])
        hi = np.array([hw, hd, h])
        dl_safe = np.where(np.abs(dl) < 1e-12, 1e-12, dl)
        t1 = (lo - ol) / dl_safe
        t2 = (hi - ol) / dl_safe
        tnear = np.minimum(t1, t2).max(axis=1)
        tfar = np.maximum(t1, t2).min(axis=1)
        hit = (tnear <= tfar) & (tnear > 0.1)
        t_best = np.where(hit, np.minimum(t_best, tnear), t_best)
    return t_best


def _intersect_terrain(o, d, terrain, max_range):
    down = d[:, 2] < -0.005
    dz = np.where(down, d[:, 2], -1.0)
    t = np.clip((terrain.height(o[0], o[1]) - o[2]) / dz, 0.2, 2.0 * max_range)
    for _ in range(12):
        x = o[0] + t * d[:, 0]
        y = o[1] + t * d[:, 1]
        t_new = np.clip((terrain.height(x, y) - o[2]) / dz, 0.2, 2.0 * max_range)
        t = 0.5 * (t + t_new)
    resid = np.abs(o[2] + t * d[:, 2] - terrain.height(o[0] + t * d[:, 0], o[1] + t * d[:, 1]))
    return np.where(down & (resid < 0.05), t, np.inf)


def _intersect_cylinders(o, d, cyls, z_lo=0.0):
    if len(cyls) == 0:
        return np.full(len(d), np.inf)
    ox = o[0] - cyls[:, 0]
    oy = o[1] - cyls[:, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyls[:, 2] ** 2
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = np.sqrt(np.where(ok, disc, 0.0))
    a_safe = np.where(a < 1e-12, 1e-12, a)
    t = (-b - sq) / (2.0 * a_safe)
    z = o[2] + t * dz
    valid = ok & (t > 0.1) & (z >= z_lo) & (z <= cyls[:, 3])
    return np.where(valid, t, np.inf).min(axis=1)


def lidar_scan(scene: Scene, pose: np.ndarray, rng: np.random.RandomState, n_rings: int = 44,
               n_azimuths: int = 1100, max_range: float = 80.0, range_noise: float = 0.02,
               voxel_size: float = 0.3, fov_deg: Optional[float] = None,
               dropout: float = 0.0) -> np.ndarray:
    """Render one scan from a world-from-sensor pose -> (N, 4) xyzi float32
    in the sensor frame, voxel downsampled at ``voxel_size``."""
    rays = _ray_dirs(n_rings, n_azimuths)
    if fov_deg is not None:
        az = np.degrees(np.arctan2(rays[:, 1], rays[:, 0]))
        rays = rays[np.abs(az) <= fov_deg / 2.0]
    rot, org = pose[:3, :3], pose[:3, 3]
    d = rays @ rot.T
    if scene.terrain is not None:
        t_ground = _intersect_terrain(org, d, scene.terrain, max_range)
        z_lo = -2.5
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ground = np.where(d[:, 2] < -1e-9, -org[2] / d[:, 2], np.inf)
        z_lo = 0.0
    clutter = scene.clutter_boxes()
    solids = np.concatenate([scene.boxes, clutter]) if len(clutter) else scene.boxes
    t = np.minimum(t_ground, _intersect_boxes(org, d, solids, z_lo=z_lo))
    t = np.minimum(t, _intersect_cylinders(org, d, scene.cylinders, z_lo=z_lo))
    hit = np.isfinite(t) & (t < max_range)
    if dropout > 0.0:
        p = dropout * (0.35 + 0.65 * t[hit] / max_range)
        keep = rng.rand(hit.sum()) >= p
        hit[np.flatnonzero(hit)[~keep]] = False
    t = t[hit] + rng.randn(hit.sum()) * range_noise
    pts_world = org + t[:, None] * d[hit]
    pts_sensor = (pts_world - org) @ rot
    inten = (1.0 / (1.0 + t / 20.0)).astype(np.float32)
    scan = np.concatenate([pts_sensor.astype(np.float32), inten[:, None]], axis=1)
    return voxel_downsample_xyzi(scan, voxel_size)


def procedural_sequence(seed: int, n_frames: int, n_rings: int = 44, n_azimuths: int = 1100,
                        step: float = 10.0, fov_deg: Optional[float] = None,
                        enrich: bool = False, dropout: float = 0.0):
    """One scene + trajectory -> (scans, poses). The transform aligning
    frame j onto frame i is ``inv(poses[i]) @ poses[j]``."""
    rng = np.random.RandomState(seed)
    scene = make_scene(rng, corridor_length=max(60.0, n_frames * step + 30.0), enrich=enrich)
    poses = trajectory(rng, n_frames, step=step, scene=scene if enrich else None)
    scans = [lidar_scan(scene, poses[k], rng, n_rings=n_rings, n_azimuths=n_azimuths,
                        fov_deg=fov_deg, dropout=dropout) for k in range(n_frames)]
    return scans, poses


def procedural_pair(seed: int, step: float = 10.0, **scan_kwargs):
    """(ref (N, 3), src (M, 3), transform (4, 4) src -> ref) float32 from two
    consecutive frames of one procedural sequence."""
    scans, poses = procedural_sequence(seed, 2, step=step, **scan_kwargs)
    transform = np.linalg.inv(poses[0]) @ poses[1]
    return (scans[0][:, :3].astype(np.float32), scans[1][:, :3].astype(np.float32),
            transform.astype(np.float32))
