"""The port's ``utils/viz.py`` against the JAX package's, on the same
inputs: every case requires equal output arrays (exact; both are host
numpy and OpenCV code, so any difference is a porting fault).

Cases: the heatmap tile with zoom on and off, flipped and unflipped, the
stride-0 branch (a coordinate mask over fewer slices than asked for), an
empty coordinate mask (``None``); ``_zoom_to`` at orders 0 and 1; the
confusion-matrix RGB array of ``plot_confusion_matrix_from_data`` +
``plot_to_numpy_array``; ``save_image`` of a uint8 and a float32 array,
read back.
"""
import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu.utils import viz as jviz
from bodyct_dram_emph_subtype_tpu_torch.utils import viz


def _volume(rng, shape=(12, 20, 28)):
    image = rng.randint(0, 256, shape).astype(np.uint8)
    lung = np.zeros(shape, bool)
    lung[2:10, 4:16, 5:24] = True
    rows = [[(rng.rand(*shape) * 255).astype(np.uint8)] for _ in range(3)]
    return image, rows, lung


@pytest.mark.parametrize("zoom_size,flip_axis,slices,coord", [
    (360, 0, 5, "lung"),        # the trainer's call
    (None, 0, 5, "lung"),       # zoom off
    (64, None, 5, "lung"),      # no flip
    (64, 0, 5, "two_slices"),   # (e - s) // num_slices == 0
    (None, 0, 5, "empty"),      # returns None
    (48, 1, 3, "lung"),
])
def test_tile_equals_jax(zoom_size, flip_axis, slices, coord):
    rng = np.random.RandomState(1)
    image, rows, lung = _volume(rng)
    if coord == "two_slices":
        lung[:] = False
        lung[5:7, 3:9, 4:11] = True
    elif coord == "empty":
        lung[:] = False
    kw = dict(zoom_size=zoom_size, flip_axis=flip_axis, coord_axis=0,
              titles=["lung", "cle", "pse"])
    want = jviz.draw_mask_tile_singleview_heatmap(image, rows, lung, slices,
                                                  None, **kw)
    got = viz.draw_mask_tile_singleview_heatmap(image, rows, lung, slices,
                                                None, **kw)
    if coord == "empty":
        assert want is None and got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [0, 1])
def test_zoom_to_equals_jax(order):
    vol = (np.random.RandomState(2).rand(7, 13, 9) * 255).astype(np.uint8)
    for out_shape in ((7, 30, 21), (7, 5, 4), (3, 13, 17)):
        np.testing.assert_array_equal(viz._zoom_to(vol, out_shape, order),
                                      jviz._zoom_to(vol, out_shape, order))


def test_confusion_matrix_array_equals_jax():
    rng = np.random.RandomState(3)
    y_true, y_pred = rng.randint(0, 6, 40), rng.randint(0, 6, 40)
    y_true[:3] = 5          # a class never predicted right
    arrays = [mod.plot_to_numpy_array(mod.plot_confusion_matrix_from_data(
        y_true, y_pred, list(range(6)), line_width=0.5, fig_size=10,
        font_size=11)) for mod in (viz, jviz)]
    assert arrays[0].ndim == 3 and arrays[0].shape[2] == 3
    np.testing.assert_array_equal(*arrays)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_save_image_round_trip_equals_jax(tmp_path, dtype):
    import cv2
    rng = np.random.RandomState(4)
    rgb = (rng.rand(9, 11, 3) * (255 if dtype == np.uint8 else 1)
           ).astype(dtype)
    viz.save_image(tmp_path / "port.png", rgb)
    jviz.save_image(tmp_path / "jax.png", rgb)
    got = cv2.imread(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "jax.png")))
    want = rgb if dtype == np.uint8 else np.uint8(rgb * 255)
    np.testing.assert_array_equal(got[..., ::-1], want)
