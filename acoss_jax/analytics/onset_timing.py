"""Onset-timing topology: sublevel-set persistence of tempo curves.

Parity target: `/root/reference/coverstats/OnsetTiming.py:21-148`:
smoothed local-tempo curves from beat onsets, H0 sublevel-set persistence
(the reference uses ripser on a sparse path-graph matrix; here a direct
union-find over the 1-D filtration — exact, O(n log n)), and persistence
images (Adams et al.) as stable descriptors.
"""

from __future__ import annotations

import numpy as np
import scipy.stats
from scipy.ndimage import gaussian_filter1d as gf1d
from scipy.stats import ks_2samp


def lower_star_persistence(x: np.ndarray,
                           infinity_max: bool = True) -> np.ndarray:
    """H0 sublevel-set persistence diagram of a 1-D function.

    Union-find with the elder rule over the path graph: components are
    born at local minima and die when merged at saddles; the essential
    class dies at max(x) when `infinity_max` (the reference's convention,
    `OnsetTiming.py:21-39`). Returns (n, 2) [birth, death] pairs.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    n = x.size
    if n == 0:
        return np.zeros((0, 2))
    order = np.argsort(x, kind="stable")
    parent = np.full(n, -1, dtype=np.int64)   # -1 = not yet alive
    root_min = {}                              # root -> birth value
    dgm = []

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for v in order:
        parent[v] = v
        root_min[v] = x[v]
        for nb in (v - 1, v + 1):
            if 0 <= nb < n and parent[nb] != -1:
                ra, rb = find(v), find(nb)
                if ra == rb:
                    continue
                # elder rule: the younger component (larger birth) dies
                if root_min[ra] > root_min[rb]:
                    ra, rb = rb, ra
                dgm.append((root_min[rb], x[v]))
                parent[rb] = ra
                del root_min[rb]
    # essential class
    birth = min(root_min.values())
    death = np.max(x) if infinity_max else np.inf
    dgm.append((birth, death))
    dgm = np.array(dgm, dtype=np.float64)
    # drop zero-persistence classes (every non-critical vertex merges
    # instantly on insertion); ripser's dgm0 omits them as well
    return dgm[dgm[:, 1] > dgm[:, 0]]


def persistence_image(dgm: np.ndarray, plims, res: float,
                      weightfn=lambda b, l: l,
                      psigma: float | None = None) -> dict:
    """Persistence image (Adams et al.) — `OnsetTiming.py:41-78`:
    birth/lifetime axes, integrated Gaussians weighted by `weightfn`."""
    I = np.array(dgm, dtype=np.float64)
    if I.size == 0:
        I = np.zeros((0, 2))
    I[:, 1] = I[:, 1] - I[:, 0]
    lims = np.array([np.floor(plims[0] / res), np.ceil(plims[1] / res),
                     np.floor(plims[2] / res), np.ceil(plims[3] / res)])
    xr = np.arange(int(lims[0]), int(lims[1]) + 2) * res
    yr = np.arange(int(lims[2]), int(lims[3]) + 2) * res
    sigma = psigma if psigma else res / 2.0
    PI = np.zeros((len(yr) - 1, len(xr) - 1))
    for bx, ly in I:
        w = weightfn(bx, ly)
        if w == 0:
            continue
        xcdf = scipy.stats.norm.cdf((xr - bx) / sigma)
        ycdf = scipy.stats.norm.cdf((yr - ly) / sigma)
        X = ycdf[:, None] * xcdf[None, :]
        PI += w * (X[1:, 1:] - X[:-1, 1:] - X[1:, :-1] + X[:-1, :-1])
    return {"PI": PI, "xr": xr[:-1], "yr": yr[:-1]}


def get_onset_means(onsets: np.ndarray, win: int = 20, sigma: float = 1.0,
                    truncate: int = 4, edge: int = 10) -> np.ndarray:
    """Smoothed local-tempo curve from onset indices, normalized by its
    median (`OnsetTiming.py:81-101`)."""
    x = np.asarray(onsets, dtype=np.float64).ravel()
    if x.size <= 2 * edge + 2 * truncate * int(sigma) + win:
        return np.ones(1)
    x = x[edge:-edge]
    x = gf1d(x, sigma, truncate=truncate, order=1, mode="reflect")
    t = truncate * int(sigma)
    x = x[t:-t]
    M = x.size - win + 1
    X = np.stack([x[k:k + M] for k in range(win)], axis=1)
    ret = X.mean(axis=1)
    med = np.median(ret)
    return ret / (med if med != 0 else 1.0)


#: the reference study's persistence-image grid (`OnsetTiming.py:107-110`):
#: tempo-ratio curves live in ~[0, 2], so up-filtration births span
#: [0.5, 1.5] and down-filtration (of -y) births span [-1.5, -0.5]
PI_LIMS = (0.5, 1.5, 0.0, 1.0)
PI_LIMS_NEG = (-1.5, -0.5, 0.0, 1.0)
PI_RES = 0.004
PI_SIGMA = 0.04


def onset_pi_descriptor(onsets: np.ndarray,
                        pilims=PI_LIMS, pilimsneg=PI_LIMS_NEG,
                        pires: float = PI_RES, psigma: float = PI_SIGMA,
                        reference_quirk_up_for_down: bool = False,
                        ) -> np.ndarray:
    """Per-track persistence-image descriptor of the local-tempo curve.

    The reference's per-track inner loop (`OnsetTiming.py:113-125`):
    smoothed tempo curve -> up + down sublevel-set filtrations -> two
    persistence images, concatenated flat.

    `reference_quirk_up_for_down` reproduces `OnsetTiming.py:120`, which
    passes the UP diagram to the down-image grid (whose birth range the
    up births fall outside, so that half of the descriptor is ~0 there);
    the default uses the down filtration as evidently intended.
    """
    y = get_onset_means(np.asarray(onsets, dtype=np.float64).ravel())
    IUp = lower_star_persistence(y)
    PIUp = persistence_image(IUp, pilims, pires, psigma=psigma)["PI"]
    IDown = lower_star_persistence(-y)
    src = IUp if reference_quirk_up_for_down else IDown
    PIDown = persistence_image(src, pilimsneg, pires, psigma=psigma)["PI"]
    return np.concatenate([PIUp.ravel(), PIDown.ravel()])


def _paired_members(fs):
    """label -> first two member song indices, in dataset order
    (the reference's pairs dict, `coverstats.py:10-37`)."""
    pairs: dict = {}
    for i in range(fs.n_songs):
        pairs.setdefault(str(fs.labels[i]), []).append(i)
    out = {}
    for label, members in pairs.items():
        if len(members) >= 2:
            out[label] = members[:2]
    return out


def onset_timing_study(fs, feature: str = "onsets",
                       pires: float = PI_RES, psigma: float = PI_SIGMA,
                       reference_quirk_up_for_down: bool = False) -> dict:
    """Dataset-level persistence-image study
    (`OnsetTiming.py:104-148` / getAllPersistenceImages).

    Computes the PI descriptor for both members of every cover pair,
    then the Euclidean cross-distance matrix between the two member
    sets: diagonal entries are true-cover distances, off-diagonal are
    false-cover distances; compared with a two-sample KS test.
    """
    pairs = _paired_members(fs)
    labels = sorted(pairs)
    Is1, Is2 = [], []
    for label in labels:
        a, b = pairs[label]
        for k, idx in enumerate((a, b)):
            ons = fs.feature(feature)[idx, :fs.length(feature)[idx]]
            desc = onset_pi_descriptor(
                ons, pires=pires, psigma=psigma,
                reference_quirk_up_for_down=reference_quirk_up_for_down)
            (Is1 if k == 0 else Is2).append(desc)
    Is1 = np.asarray(Is1, dtype=np.float32)
    Is2 = np.asarray(Is2, dtype=np.float32)
    from acoss_jax.ops import crp

    D = np.asarray(crp.get_csm(Is1, Is2))
    dcover = np.diag(D).copy()
    mask = ~np.eye(D.shape[0], dtype=bool)
    dfalse = D[mask]
    ks = ks_2samp(dcover, dfalse) if len(dcover) > 1 else None
    return {"labels": labels, "Is1": Is1, "Is2": Is2, "D": D,
            "dcover": dcover, "dfalse": dfalse, "ks": ks,
            "mean_cover": float(dcover.mean()) if len(dcover) else None,
            "mean_false": float(dfalse.mean()) if len(dfalse) else None}


def onset_stdev_study(fs, feature: str = "onsets") -> dict:
    """Dataset-level tempo-curve standard-deviation study
    (`OnsetTiming.py:151-181` / getAllSTDevs): |std(y1) - std(y2)| for
    true vs false pairs, compared with a KS test."""
    pairs = _paired_members(fs)
    labels = sorted(pairs)
    stdevs = np.zeros((len(labels), 2))
    for i, label in enumerate(labels):
        for k, idx in enumerate(pairs[label]):
            ons = fs.feature(feature)[idx, :fs.length(feature)[idx]]
            stdevs[i, k] = np.std(get_onset_means(
                np.asarray(ons, dtype=np.float64).ravel()))
    D = np.abs(stdevs[:, 0][:, None] - stdevs[:, 1][None, :])
    dcover = np.diag(D).copy()
    dfalse = D[~np.eye(D.shape[0], dtype=bool)]
    ks = ks_2samp(dcover, dfalse) if len(dcover) > 1 else None
    return {"labels": labels, "stdevs": stdevs,
            "dcover": dcover, "dfalse": dfalse, "ks": ks,
            "mean_cover": float(dcover.mean()) if len(dcover) else None,
            "mean_false": float(dfalse.mean()) if len(dfalse) else None}
