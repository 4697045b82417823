"""Renders: 2D projections (PNG, HDF5, ANSI terminal image) and 3D
scatter renders, and the power-spectrum and bispectrum plots (port of
concept_tpu/graphics/render.py; reference src/graphics.py: render2D
:1027 with projection, enhancement and terminal output :1901-1969,
render3D :1970-3518, plot_powerspec :45, plot_bispec :179).

The device work is two deposits on the positions' device: the density
projection (grid/interp.deposit and a sum along an axis) and the
per-particle CIC density of the 3D render (``index_add_`` over the 8
corners, float64).  The images are host numpy and matplotlib, imported
where they are drawn, as in the JAX package; HDF5 dumps import h5py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from concept_tpu_torch.grid.interp import deposit


def _tensor(pos):
    """Positions as a tensor (numpy arrays on the CPU)."""
    return pos if isinstance(pos, torch.Tensor) else torch.as_tensor(np.asarray(pos))


def project_density(pos, gridsize: int, boxsize: float, axis: int = 2,
                    order: int = 2, extent=None):
    """Deposit particles and project along ``axis`` → (n, n) numpy image.

    extent: optional (lo, hi) slab bounds along the projection axis
    (reference render2D_options 'extent', graphics.py:1374): particles
    outside deposit nothing."""
    pos = _tensor(pos)
    if extent is not None:
        lo, hi = extent
        x = pos[:, axis]
        w = ((x >= lo) & (x < hi)).to(pos.dtype)
    else:
        w = 1.0
    grid = deposit(pos, w, gridsize, boxsize, order=order)
    return grid.sum(dim=axis).cpu().numpy()


def enhance(img: np.ndarray, clip_percentile: float = 99.5, log: bool = True):
    """Contrast enhancement ~ reference's gridsize-independent enhancement
    (graphics.py:1568): log-scale + percentile clipping → [0,1]."""
    img = np.asarray(img, dtype=np.float64)
    if log:
        img = np.log1p(img / max(img.mean(), 1e-300))
    hi = np.percentile(img, clip_percentile)
    lo = img.min()
    return np.clip((img - lo) / max(hi - lo, 1e-300), 0, 1)


def render2D(
    pos,
    gridsize: int,
    boxsize: float,
    filename: str | None = None,
    axis: int = 2,
    colormap: str = "inferno",
    terminal: bool = False,
    terminal_resolution: int = 80,
    save_data: bool = False,
    data_filename: str | None = None,
    extent=None,
    enhancement: bool = True,
):
    """Full render2D: returns the enhanced image; optionally saves PNG,
    HDF5 data dump and/or prints an ANSI block (reference
    render2D_select data/image/terminal image — each artifact is
    independently selectable).  ``enhancement`` toggles the
    gridsize-independent contrast enhancement (reference
    render2D_options 'enhancement', graphics.py:1568)."""
    img = project_density(pos, gridsize, boxsize, axis=axis, extent=extent)
    if enhancement:
        enhanced = enhance(img)
    else:
        lo, hi = float(np.min(img)), float(np.max(img))
        enhanced = (img - lo) / (hi - lo if hi > lo else 1.0)
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(filename, enhanced.T[::-1], cmap=colormap)
    if save_data and (data_filename or filename):
        import h5py

        fn = data_filename or filename.rsplit(".", 1)[0] + ".hdf5"
        os.makedirs(os.path.dirname(os.path.abspath(fn)), exist_ok=True)
        with h5py.File(fn, "w") as f:
            f.create_dataset("data", data=img)
            f.attrs["axis"] = axis
            f.attrs["boxsize"] = boxsize
    if terminal:
        print(terminal_render(enhanced, terminal_resolution, colormap))
    return enhanced


def terminal_render(enhanced: np.ndarray, resolution: int = 80,
                    colormap: str = "inferno") -> str:
    """ANSI 256-color terminal image (reference graphics.py:1901-1969;
    replayable from logs with the play utility)."""
    import matplotlib

    matplotlib.use("Agg")

    n = enhanced.shape[0]
    res = min(resolution, n)
    # downsample by block averaging; 2 rows per character via ▀
    step = max(1, n // res)
    img = enhanced[::step, ::step]
    cmap = matplotlib.colormaps.get_cmap(colormap)
    rgb = (np.asarray(cmap(img))[:, :, :3] * 255).astype(int)
    lines = []
    h = img.shape[1]
    for j in range(h - 2, -1, -2):
        line = []
        for i in range(img.shape[0]):
            top = rgb[i, j + 1]
            bot = rgb[i, j]
            line.append(
                f"\033[38;2;{top[0]};{top[1]};{top[2]}m"
                f"\033[48;2;{bot[0]};{bot[1]};{bot[2]}m▀"
            )
        lines.append("".join(line) + "\033[0m")
    return "\n".join(lines)


def _cic_density_at_particles(p, gridsize: int, boxsize: float):
    """Per-particle density by a CIC deposit and nearest-grid sampling
    (the reference colours 3D scatter points by interpolated density,
    graphics.py:2322-2345 fetch_render3D_data), on the positions' device
    with the JAX package's host arithmetic: u = p/h − ½ in the positions'
    dtype (numpy's for a float32 array), the fractions, weights and grid
    in float64, ``index_add_`` over the 8 corners in its corner order.
    The cell width is a tensor of the positions' dtype: PyTorch on CUDA
    multiplies by the reciprocal of a Python-number divisor, which moves
    particles across cell faces.  Returns a float64 tensor."""
    p = _tensor(p)
    n = gridsize
    h = torch.tensor(boxsize / n, dtype=p.dtype, device=p.device)
    u = p / h - 0.5
    i0 = torch.floor(u).to(torch.int64)
    f = u.to(torch.float64) - i0
    grid = torch.zeros(n**3, dtype=torch.float64, device=p.device)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = (
                    (1 - f[:, 0] if cx == 0 else f[:, 0])
                    * (1 - f[:, 1] if cy == 0 else f[:, 1])
                    * (1 - f[:, 2] if cz == 0 else f[:, 2])
                )
                idx = (((i0[:, 0] + cx) % n) * n + (i0[:, 1] + cy) % n) * n + (i0[:, 2] + cz) % n
                grid.index_add_(0, idx, w)
    idx = torch.clamp(torch.round(u).to(torch.int64), min=0) % n
    return grid[(idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2]]


def blend_images(img0: np.ndarray, img1: np.ndarray, mode: str = "overunder"):
    """Alpha-blend img1 into img0 (both (H,W,4) float in [0,1]) —
    vectorized port of the reference blend semantics (graphics.py:3370):
    'screen', 'over', 'under', 'overunder' (mean of over and under)."""
    if mode not in ("screen", "over", "under", "overunder"):
        raise ValueError(f"unknown blend mode {mode!r}")
    a0 = img0[..., 3:4]
    a1 = img1[..., 3:4]
    alpha = a0 + a1 - a0 * a1
    w0, w1 = a0, a1  # 'screen'
    if mode == "over":
        w1 = a1 * (1 - a0)
    elif mode == "under":
        w0 = a0 * (1 - a1)
    elif mode == "overunder":
        w0 = 0.5 * (a0 + a0 * (1 - a1))
        w1 = 0.5 * (a1 + a1 * (1 - a0))
    denom = np.where(alpha > 0, alpha, 1.0)
    rgb = (w0 * img0[..., :3] + w1 * img1[..., :3]) / denom
    out = np.concatenate([np.clip(rgb, 0, 1), np.clip(alpha, 0, 1)], axis=-1)
    img0[...] = out
    return img0


def _perceived_brightness(img: np.ndarray) -> float:
    """α-weighted RMS perceived brightness (reference
    get_perceived_brightness, graphics.py:3233-3330)."""
    lum = (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    ) * img[..., 3]
    return float(np.sqrt(np.mean(lum**2)))


def enhance_brightness(img: np.ndarray, target: float = 0.15,
                       iterations: int = 40):
    """Scale the image brightness towards an RMS target by bisection on
    the brighten factor (clipping makes it non-linear) — the reference's
    enhance_brightness_render3D (graphics.py:3233)."""
    if target < 0:
        return img
    lo, hi = 1.0 / 2**20, 2.0**20

    def bright(fac):
        out = img.copy()
        out[..., :3] = np.clip(out[..., :3] * fac, 0, 1)
        return _perceived_brightness(out)

    for _ in range(iterations):
        mid = np.sqrt(lo * hi)
        if bright(mid) < target:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1.01:
            break
    fac = np.sqrt(lo * hi)
    img[..., :3] = np.clip(img[..., :3] * fac, 0, 1)
    return img


def render3D_component(
    pos,
    boxsize: float,
    resolution: int = 1080,
    elevation: float = 20.0,
    azimuth: float = -60.0,
    roll: float = 0.0,
    zoom: float = 1.0,
    projection: str = "persp",
    colormap: str = "inferno",
    colormap_lims=(0.1, 1.0),
    background=None,
    max_particles: int = 1_000_000,
    depthshade: bool = True,
    density_gridsize: int | None = None,
) -> np.ndarray:
    """Render one component to an (H, W, 4) float RGBA array: scatter
    points coloured by their interpolated local density through
    ``colormap`` restricted to ``colormap_lims`` (reference
    compute_render3D_single, graphics.py:2279-2369)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pt = _tensor(pos)
    if len(pt) > max_particles:
        idx = np.random.default_rng(0).choice(len(pt), max_particles, replace=False)
        pt = pt[torch.as_tensor(idx, device=pt.device)]
    if density_gridsize is None:
        density_gridsize = max(16, min(128, int(round(len(pt) ** (1 / 3)))))
    rho = _cic_density_at_particles(pt, density_gridsize, boxsize).cpu().numpy()
    p = pt.cpu().numpy()
    lo, hi = colormap_lims
    logrho = np.log10(rho + 1e-10)
    lr_lo, lr_hi = np.percentile(logrho, [1, 99.5])
    t = np.clip((logrho - lr_lo) / max(lr_hi - lr_lo, 1e-10), 0, 1)
    cmap = plt.get_cmap(colormap)
    colors = cmap(lo + (hi - lo) * t)
    marker = max(0.05, 6e4 / max(len(p), 1) ** (2 / 3) * zoom)
    fig = plt.figure(figsize=(resolution / 100, resolution / 100), dpi=100)
    ax = fig.add_subplot(projection="3d")
    ax.set_facecolor((0, 0, 0, 0))
    fig.patch.set_alpha(0.0)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=marker, c=colors, alpha=0.45,
               depthshade=depthshade, linewidths=0)
    try:
        ax.view_init(elev=elevation, azim=azimuth, roll=roll)
    except TypeError:  # older matplotlib without roll
        ax.view_init(elev=elevation, azim=azimuth)
    if projection in ("ortho", "orthographic"):
        ax.set_proj_type("ortho")
    half = 0.5 * boxsize
    span = half / max(zoom, 1e-10)
    ax.set_xlim(half - span, half + span)
    ax.set_ylim(half - span, half + span)
    ax.set_zlim(half - span, half + span)
    ax.set_axis_off()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba(), dtype=np.float64) / 255.0
    plt.close(fig)
    return img


def render3D(
    pos,
    boxsize: float,
    filename: str,
    resolution: int = 1080,
    elevation: float = 20.0,
    azimuth: float = -60.0,
    roll: float = 0.0,
    zoom: float = 1.0,
    projection: str = "persp",
    color: str | None = None,
    colormap: str = "inferno",
    background: str = "black",
    max_particles: int = 1_000_000,
    depthshade: bool = True,
    enhance_target: float = 0.15,
    components: dict | None = None,
    blend: str = "overunder",
    label: str | None = None,
):
    """3D render (reference render3D, graphics.py:1970-3518): density-
    coloured scatter per component, alpha-blended across components
    ('overunder' default), brightness-enhanced, over a solid background.

    components: optional {name: (pos, colormap)} dict — when given,
    ``pos`` is ignored and each component renders with its own colormap
    before blending (reference multi-component declarations)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import to_rgba

    view = dict(
        resolution=resolution, elevation=elevation, azimuth=azimuth,
        roll=roll, zoom=zoom, projection=projection,
        max_particles=max_particles, depthshade=depthshade,
    )
    if components:
        img = None
        n_comp = len(components)
        lims_hi = [0.75 + 0.25 * i / max(n_comp - 1, 1) for i in range(n_comp)]
        for i, (name, spec_) in enumerate(components.items()):
            cpos, cmap = spec_ if isinstance(spec_, tuple) else (spec_, colormap)
            im = render3D_component(
                cpos, boxsize, colormap=cmap,
                colormap_lims=(0.1, lims_hi[i]), **view,
            )
            img = im if img is None else blend_images(img, im, blend)
        enhance_brightness(img, enhance_target)
    else:
        cmap = colormap if color is None else None
        if cmap is not None:
            img = render3D_component(pos, boxsize, colormap=cmap, **view)
            enhance_brightness(img, enhance_target)
        else:
            # single flat colour (legacy path)
            img = render3D_component(pos, boxsize, colormap="viridis", **view)
            rgba = np.asarray(to_rgba(color))
            img[..., :3] = rgba[:3] * img[..., 3:4]
    # composite over the background
    bg = np.asarray(to_rgba(background))
    alpha = img[..., 3:4]
    out = img[..., :3] * alpha + bg[:3] * (1 - alpha)
    fig = plt.figure(
        figsize=(out.shape[1] / 100, out.shape[0] / 100), dpi=100
    )
    ax = fig.add_axes([0, 0, 1, 1])
    ax.imshow(np.clip(out, 0, 1))
    ax.set_axis_off()
    if label:
        ax.text(0.02, 0.97, label, color="white", fontsize=12,
                transform=ax.transAxes, va="top")
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    fig.savefig(filename, dpi=100)
    plt.close(fig)
    return filename


def plot_bispec(out: dict, filename: str, treelevel=None, a: float = 1.0,
                prefer: str = "bispec"):
    """B(k) plot for a 1-parameter triangle family (reference
    graphics.py:179 plot_bispec).  ``prefer``: 'bispec' plots B,
    'reduced' plots the reduced Q (reference bispec_plot_prefer,
    param/example_explanatory:530)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k1 = out["triangles"][:, 0]
    fig, ax = plt.subplots(figsize=(7, 5))
    if str(prefer).startswith("red") and "Q" in out:
        ax.semilogx(k1, out["Q"], "o-", label="simulation Q")
        ax.set_ylabel("reduced Q(k₁,k₂,k₃)")
    else:
        ax.loglog(k1, np.abs(out["B"]), "o-", label="simulation |B|")
        ax.set_ylabel("B(k₁,k₂,k₃)")
    if treelevel is not None and not str(prefer).startswith("red"):
        ax.loglog(k1, np.abs(treelevel), ":", label="tree level")
    ax.set_xlabel("k₁")
    ax.set_title(f"a = {a:.4g}")
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    fig.savefig(filename, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return filename


def plot_powerspec(pk: dict, filename: str, linear=None, a: float = 1.0):
    """P(k) plot (reference graphics.py:45 plot_powerspec)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.loglog(pk["k"], pk["power"], label="simulation")
    if "power_corrected" in pk:
        ax.loglog(pk["k"], np.maximum(pk["power_corrected"], 1e-300), "--",
                  label="corrected")
    if linear is not None:
        ax.loglog(pk["k"], linear, ":", label="linear")
    ax.set_xlabel("k")
    ax.set_ylabel("P(k)")
    ax.set_title(f"a = {a:.4g}")
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    fig.savefig(filename, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return filename
