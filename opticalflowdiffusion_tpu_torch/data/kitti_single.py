"""KITTI-2015 flow pairs with the sparse ground truth densified (JAX
``data/kitti_single.py``), without cv2.

Reads ``KITTI/<train|val>/training/image_2/%06d_1{0,1}.png`` and the 16-bit
``flow_occ/%06d_10.png``; a split other than ``training`` reads ``val``.
The sparse flow is filled over its invalid pixels as
``cv2.inpaint(radius 20, INPAINT_NS)`` fills each channel (the host
helper's ``inpaint_ns``, equal to cv2 bit for bit; ``inpaint_ns_plain`` is
its numpy version), the valid pixels kept exactly, then resized nearest
with the flow rescaled to the resized pixels.  Emits (img1, img2, flow)
float32 NHWC, flow (dx, dy).

The densified field is memoised per file (64 entries, the oldest evicted
first): the inpaint costs seconds an item and every epoch revisits every
item.  A lock guards the memo, so the loader's threads may share a
dataset; two threads that miss on one file both compute it, and the first
to finish stores it.
"""

from __future__ import annotations

import heapq
import threading

import numpy as np

from . import host
from .flow_io import read_kitti_png
from .png import imread
from .resize import resize
from .sintel import _data_root, image_size

INPAINT_RADIUS = 20.0
CACHE_SIZE = 64

KNOWN, BAND, INSIDE = 0, 1, 2


def _solve(i1, j1, i2, j2, f, t) -> np.float32:
    a11, a22 = float(t[i1, j1]), float(t[i2, j2])
    if f[i1, j1] != INSIDE:
        if f[i2, j2] != INSIDE:
            if abs(a11 - a22) >= 1.0:
                sol = 1 + min(a11, a22)
            else:
                sol = (a11 + a22 + np.sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5
        else:
            sol = 1 + a11
    elif f[i2, j2] != INSIDE:
        sol = 1 + a22
    else:
        sol = 1 + min(a11, a22)
    return np.float32(sol)


def inpaint_ns_plain(img: np.ndarray, mask: np.ndarray, radius: float) -> np.ndarray:
    """numpy version of ``host.inpaint_ns`` on one float32 channel: the
    same front (a heap on (time, order of pushes)), each pixel's disc of
    known neighbours in numpy, its sums in row-major order in float32."""
    img = np.asarray(img, np.float32)
    rows, cols = img.shape
    rng = max(1, min(100, int(np.rint(radius))))
    er, ec = rows + 2, cols + 2
    out = img.copy()
    inside = np.zeros((er, ec), bool)
    inside[1:-1, 1:-1] = np.asarray(mask) != 0
    f = np.where(inside, INSIDE, KNOWN).astype(np.uint8)
    near = np.zeros_like(inside)
    near[1:-1, 1:-1] = (inside[:-2, 1:-1] | inside[2:, 1:-1] | inside[1:-1, :-2]
                        | inside[1:-1, 2:])
    band = near & ~inside
    band[0, :] = band[-1, :] = band[:, 0] = band[:, -1] = False
    f[band] = BAND
    t = np.full((er, ec), 1.0e6, np.float32)
    t[band] = 0
    heap = [(0.0, n, int(i), int(j)) for n, (i, j) in enumerate(zip(*np.nonzero(band)))]
    seq = len(heap)
    heapq.heapify(heap)
    dk, dl = np.mgrid[-rng: rng + 1, -rng: rng + 1]
    disc = dk * dk + dl * dl <= rng * rng
    ry_all, rx_all = dk.astype(np.float32), dl.astype(np.float32)
    length = rx_all * rx_all + ry_all * ry_all
    dist_w = np.float32(1) / (length * length + np.float32(1))
    two = np.float32(2)
    while heap:
        _, _, ii, jj = heapq.heappop(heap)
        f[ii, jj] = KNOWN
        for i, j in ((ii - 1, jj), (ii, jj - 1), (ii + 1, jj), (ii, jj + 1)):
            if i <= 0 or j <= 0 or i > er - 1 or j > ec - 1 or f[i, j] != INSIDE:
                continue
            dist = min(_solve(i - 1, j, i, j - 1, f, t), _solve(i + 1, j, i, j - 1, f, t),
                       _solve(i - 1, j, i, j + 1, f, t), _solve(i + 1, j, i, j + 1, f, t))
            t[i, j] = dist
            k0, k1 = max(i - rng, 1), min(i + rng, er - 2)
            l0, l1 = max(j - rng, 1), min(j + rng, ec - 2)
            ks, ls = np.arange(k0, k1 + 1)[:, None], np.arange(l0, l1 + 1)[None, :]
            win = (slice(k0 - i + rng, k1 - i + rng + 1), slice(l0 - j + rng, l1 - j + rng + 1))
            use = disc[win] & (f[k0: k1 + 1, l0: l1 + 1] != INSIDE)
            y, x = ks - 1, ls - 1
            km, kp = y + (y == 0), y - (y == rows - 1)
            lm, lp = x + (x == 0), x - (x == cols - 1)
            dn = f[k0 + 1: k1 + 2, l0: l1 + 1] != INSIDE
            up = f[k0 - 1: k1, l0: l1 + 1] != INSIDE
            rt = f[k0: k1 + 1, l0 + 1: l1 + 2] != INSIDE
            lf = f[k0: k1 + 1, l0 - 1: l1] != INSIDE
            d_dn = np.abs(out[kp + 1, lm] - out[kp, lm])
            d_up = np.abs(out[kp, lm] - out[km - 1, lm])
            gx = np.where(dn, np.where(up, d_dn + d_up, d_dn * two),
                          np.where(up, d_up * two, np.float32(0)))
            d_rt = np.abs(out[km, lp + 1] - out[km, lm])
            d_lf = np.abs(out[km, lm] - out[km, lm - 1])
            gy = np.where(rt, np.where(lf, d_rt + d_lf, d_rt * two),
                          np.where(lf, d_lf * two, np.float32(0)))
            gx = -gx
            rx, ry, ln = rx_all[win], ry_all[win], length[win]
            d = rx * gx + ry * gy
            with np.errstate(divide="ignore", invalid="ignore"):
                full = np.abs(d / np.sqrt(ln * (gx * gx + gy * gy)))
            direction = np.where(np.abs(d) <= np.float32(0.01), np.float32(1e-6), full)
            w = (dist_w[win] * direction)[use]
            yy, xx = np.broadcast_arrays(y, x)
            vals = out[yy[use], xx[use]]
            ia = np.cumsum(w * vals, dtype=np.float32)[-1] if w.size else np.float32(0)
            s = np.cumsum(np.concatenate([[np.float32(1e-20)], w]), dtype=np.float32)[-1]
            out[i - 1, j - 1] = np.float32(float(ia) / float(s))
            f[i, j] = BAND
            heapq.heappush(heap, (float(dist), seq, i, j))
            seq += 1
    return out


class KittiSingleDataset:
    def __init__(self, cfg, split: str = "training"):
        self.cfg = cfg
        self.imsz = image_size(cfg)
        self._dense_cache: dict = {}
        self._cache_lock = threading.Lock()
        split = "train" if split == "training" else "val"
        base = _data_root(cfg, "KITTI") / split / "training"
        img_dir = base / "image_2"
        flow_dir = base / "flow_occ"
        if not flow_dir.exists():
            raise FileNotFoundError(
                f"No KITTI data under {base}; set dataset.root or OFD_DATA_ROOT")
        self.records = []
        for f in sorted(flow_dir.glob("*_10.png")):
            i1 = img_dir / f.name
            i2 = img_dir / f.name.replace("_10", "_11")
            if i1.exists() and i2.exists():
                self.records.append((i1, i2, f))

    def __len__(self) -> int:
        return len(self.records)

    def _densify(self, pf) -> np.ndarray:
        """The inpaint-densified ground-truth flow of ``pf``, memoised."""
        key = str(pf)
        with self._cache_lock:
            dense = self._dense_cache.get(key)
        if dense is not None:
            return dense
        flow, valid = read_kitti_png(pf)
        dense = host.inpaint_ns(flow, ~valid, INPAINT_RADIUS)
        with self._cache_lock:
            if key not in self._dense_cache:
                if len(self._dense_cache) >= CACHE_SIZE:
                    self._dense_cache.pop(next(iter(self._dense_cache)))
                self._dense_cache[key] = dense
            return self._dense_cache[key]

    def __getitem__(self, idx: int):
        p1, p2, pf = self.records[idx]
        img1, img2 = imread(p1), imread(p2)
        dense = self._densify(pf)
        h0, w0 = img1.shape[:2]
        W, H = self.imsz[0], self.imsz[-1]
        img1 = resize(img1, (W, H)).astype(np.float32) / 255.0
        img2 = resize(img2, (W, H)).astype(np.float32) / 255.0
        dense = resize(dense, (W, H), nearest=True)
        dense = dense * np.asarray([W / w0, H / h0], np.float32)
        return img1, img2, dense.astype(np.float32)


__all__ = ["KittiSingleDataset", "inpaint_ns_plain"]
