"""Host visualization artifacts (numpy): heatmap tiles and confusion
matrices.

Copy of ``bodyct_dram_emph_subtype_tpu/utils/viz.py`` (the port imports
nothing of the JAX package):

- ``windowing`` (reference ``utils.py:28-37``), ``draw_2d_heatmap``
  (``utils.py:107-117``), ``draw_mask_tile_singleview_heatmap``
  (``utils.py:120-197``): the 5-slice x 4-row JET-overlay JPEG tiles of the
  first eval batches;
- ``plot_confusion_matrix_from_data`` (``confusion_matrix.py:209-239``):
  the annotated confusion matrix with per-class precision and recall
  margins, saved as PNG and logged to TensorBoard;
- ``plot_to_numpy_array`` and ``save_image`` (``utils.py:266-282``).

``cv2``, ``matplotlib`` and ``seaborn`` are imported when a function
needs them, never at import: the trainer skips an artifact whose package
is missing (``train/loop.py``).  All of this runs on rank 0 only, off
the critical path.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def windowing(image: np.ndarray, from_span=(-1150, 350), to_span=(0, 255)
              ) -> np.ndarray:
    """NumPy HU windowing (``utils.py:28-37``)."""
    if from_span is None:
        lo, hi = np.min(image), np.max(image)
    else:
        lo, hi = from_span
    image = np.clip(image, lo, hi)
    return ((image - lo) / float(hi - lo)) * (to_span[1] - to_span[0]) + to_span[0]


def draw_2d_heatmap(image_2d: np.ndarray, masks_2d: Sequence[np.ndarray],
                    alpha: float = 0.5, color_map: str = "jet") -> np.ndarray:
    """Blend JET-colormapped masks over a grayscale slice
    (``utils.py:107-117``)."""
    import cv2
    blend = np.dstack((image_2d, image_2d, image_2d))
    cmap = {"jet": cv2.COLORMAP_JET, "summer": cv2.COLORMAP_SUMMER}[color_map]
    for mask in masks_2d:
        mask_map = cv2.applyColorMap(mask, cmap)
        blend = cv2.addWeighted(mask_map, alpha, blend, 1 - alpha, 0.0)
    return blend


def draw_mask_tile_singleview_heatmap(image: np.ndarray, masks_list,
                                      coord_mask: np.ndarray, num_slices: int,
                                      output_path, ext: str = "jpg",
                                      alpha: float = 0.5, flip_axis=0,
                                      zoom_size: Optional[int] = 360,
                                      colormap: str = "jet",
                                      coord_axis: int = 0,
                                      titles: Optional[List[str]] = None,
                                      title_offset: int = 50,
                                      title_color=(0, 255, 0),
                                      canvas_width: int = 1920) -> Optional[np.ndarray]:
    """Tile ``num_slices`` evenly-spaced slices (inside the coord-mask bbox)
    x (1 + len(masks_list)) overlay rows into one wide JPEG
    (``utils.py:120-197``)."""
    import cv2
    assert all(image.shape == m.shape for row in masks_list for m in row)
    if flip_axis is not None:
        image = np.flip(image, axis=flip_axis)
        coord_mask = np.flip(coord_mask, axis=flip_axis)
        masks_list = [[np.flip(m, axis=flip_axis) for m in row]
                      for row in masks_list]
    flat_masks = [m for row in masks_list for m in row]
    n_rows = len(masks_list)
    n_per_row = len(masks_list[0])

    if zoom_size is not None:
        sp = [image.shape[s] for s in range(image.ndim) if s != coord_axis]
        ratio = zoom_size / np.max(sp)

        def zoom_and_pad(vol, order):
            out_shape = tuple(
                n if ax == coord_axis else
                min(zoom_size, int(round(n * ratio)))
                for ax, n in enumerate(vol.shape))
            zoomed = _zoom_to(vol, out_shape, order)
            pads = tuple(
                (0, 0) if ax == coord_axis else
                ((zoom_size - s) // 2, zoom_size - s - (zoom_size - s) // 2)
                for ax, s in enumerate(zoomed.shape))
            return np.pad(zoomed, pads, mode="constant")

        image = zoom_and_pad(image, order=1)
        coord_mask = zoom_and_pad(coord_mask, order=0)
        flat_masks = [zoom_and_pad(m, order=0) for m in flat_masks]

    if np.sum(coord_mask) == 0:
        return None
    nz = np.nonzero(coord_mask)[coord_axis]
    s, e = int(nz.min()), int(nz.max()) + 1
    stride = (e - s) // num_slices
    if stride == 0:
        s, e = 0, coord_mask.shape[coord_axis] - 1
        stride = max(1, (e - s) // num_slices)
    slice_ids = list(range(s, e, stride))[:num_slices]

    columns = []
    for sid in slice_ids:
        sl = np.take(image, sid, axis=coord_axis)
        tiles = [np.dstack((sl, sl, sl))]
        for row in range(n_rows):
            masks = flat_masks[row * n_per_row:(row + 1) * n_per_row]
            mask_slices = [np.take(m, sid, axis=coord_axis) for m in masks]
            rendered = draw_2d_heatmap(sl, mask_slices, alpha, colormap)
            if titles:
                cv2.putText(rendered, titles[row],
                            (title_offset, title_offset),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, title_color, 1,
                            cv2.LINE_AA)
            tiles.append(rendered)
        columns.append(np.vstack(tiles))
    canvas = np.hstack(columns)
    pad_w = max(0, canvas_width - canvas.shape[1])
    canvas = np.pad(canvas, ((0, 0), (pad_w // 2, pad_w - pad_w // 2),
                             (0, 0)), mode="constant")
    if output_path:
        output_path = Path(output_path).absolute()
        os.makedirs(output_path.parent, exist_ok=True)
        cv2.imwrite(f"{output_path}.{ext}", canvas)
    return canvas


def _zoom_to(vol: np.ndarray, out_shape, order: int) -> np.ndarray:
    """Small nearest/linear zoom helper (scipy-free)."""
    out = vol.astype(np.float32)
    for axis, target in enumerate(out_shape):
        n = out.shape[axis]
        if n == target:
            continue
        if order == 0:
            idx = np.minimum((np.arange(target) * (n / target)).astype(int),
                             n - 1)
            out = np.take(out, idx, axis=axis)
        else:
            src = np.linspace(0, n - 1, target)
            i0 = np.floor(src).astype(int)
            i1 = np.minimum(i0 + 1, n - 1)
            w = (src - i0).reshape([-1 if a == axis else 1
                                    for a in range(out.ndim)])
            out = (np.take(out, i0, axis=axis) * (1 - w)
                   + np.take(out, i1, axis=axis) * w)
    return out.astype(vol.dtype)


def plot_confusion_matrix_from_data(y_true, y_pred, columns,
                                    line_width: float = 0.5,
                                    fig_size: int = 10, font_size: int = 11):
    """Annotated confusion matrix with per-class recall/precision margins
    (functional parity with ``confusion_matrix.py:209-239``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sn

    n = len(columns)
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(np.asarray(y_true).astype(int),
                    np.asarray(y_pred).astype(int)):
        cm[t, p] += 1
    ext = np.zeros((n + 1, n + 1))
    ext[:n, :n] = cm
    ext[n, :n] = cm.sum(axis=0)
    ext[:n, n] = cm.sum(axis=1)
    ext[n, n] = cm.sum()
    annot = np.empty((n + 1, n + 1), dtype=object)
    for i in range(n):
        for j in range(n):
            annot[i, j] = str(int(cm[i, j]))
        recall = cm[i, i] / cm[i].sum() if cm[i].sum() else 0.0
        prec = cm[:, i][i] / cm[:, i].sum() if cm[:, i].sum() else 0.0
        annot[i, n] = f"{int(cm[i].sum())}\n{recall:.1%}"
        annot[n, i] = f"{int(cm[:, i].sum())}\n{prec:.1%}"
    acc = np.trace(cm) / cm.sum() if cm.sum() else 0.0
    annot[n, n] = f"{int(cm.sum())}\n{acc:.1%}"

    fig, ax = plt.subplots(figsize=(fig_size, fig_size))
    sn.heatmap(ext, annot=annot, fmt="", cmap="Oranges", cbar=False,
               linewidths=line_width, ax=ax,
               annot_kws={"size": font_size},
               xticklabels=[*map(str, columns), "recall"],
               yticklabels=[*map(str, columns), "precision"])
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    fig.tight_layout()
    return ax


def plot_to_numpy_array(plot) -> np.ndarray:
    """Render a matplotlib Axes to an RGB array (``utils.py:266-272``)."""
    import matplotlib.pyplot as plt
    fig = plot.get_figure()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close("all")
    return buf


def save_image(image_path, rgb_array: np.ndarray) -> None:
    """RGB array → file via BGR conversion (``utils.py:275-282``)."""
    import cv2
    assert rgb_array.dtype in (np.uint8, np.float32, np.float16)
    if rgb_array.dtype != np.uint8:
        rgb_array = np.uint8(rgb_array * 255)
    cv2.imwrite(str(image_path), cv2.cvtColor(rgb_array, cv2.COLOR_RGB2BGR))
