"""PyTorch port: the image writers (softmac_tpu_torch.images) and the
rendering helpers of softmac_tpu_torch.utils, on the CPU.

- The GIF decoded by PIL (here only for the test): frame count, size and
  loop 0; every frame equal to the writer's own quantisation through its
  palette, and within half a palette step of the input (25.5 on red and
  blue, 21.25 on green); a 1024 x 1024 frame (over 4000 clear codes); the
  writer's own block walk (gif_info, what the card's host reads) agrees.
- The PNG: PIL reads the writer's file back exactly; read_png reads it and
  refuses PIL's filtered PNGs and JPEG frames, saying why.
- make_gif_from_files over a directory of the writer's PNGs;
  plot_loss_curve's losses.npy and loss_curve.png (the curve's colour in
  its box, non-finite values skipped).
- utils.render's frames and interval rule against the JAX package's on a
  recording stand-in env (reset, step, render calls in order), with and
  without actions, interval 0 taken as 1.
"""
import numpy as np
import pytest
from PIL import Image

from softmac_tpu import utils as jutils

from softmac_tpu_torch import images
from softmac_tpu_torch import utils as tutils

STEP = np.array([255 / 5, 255 / 6, 255 / 5])


def _frames(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape + (3,), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("shape,n", [((97, 131), 3), ((1024, 1024), 1),
                                     ((1, 1), 2)])
def test_gif_round_trip_through_pil(tmp_path, shape, n):
    frames = _frames(shape, n)
    path = tmp_path / "t.gif"
    images.write_gif(path, frames)
    pal = images.palette()
    with Image.open(path) as im:
        assert im.n_frames == n and im.info["loop"] == 0
        assert im.size == shape[::-1]
        for i, frame in enumerate(frames):
            im.seek(i)
            got = np.asarray(im.convert("RGB"))
            np.testing.assert_array_equal(got, pal[images.quantize(frame)])
            err = np.abs(got.astype(float) - frame)
            assert (err <= STEP / 2 + 1e-9).all()
    assert images.gif_info(path) == {"size": shape[::-1], "frames": n,
                                     "loop": 0}


def test_palette_and_quantize():
    pal = images.palette()
    assert pal.shape == (256, 3) and len(np.unique(pal[:252], axis=0)) == 252
    levels = np.arange(256, dtype=np.uint8)
    img = np.stack([levels] * 3, axis=-1)[None]
    q = images.quantize(img)[0]
    np.testing.assert_array_equal(pal[q],
                                  pal[images.quantize(pal[q][None])[0]])
    assert q[0] == 0 and tuple(pal[q[-1]]) == (255, 255, 255)
    with pytest.raises(ValueError, match="uint8"):
        images.quantize(img.astype(np.float32))


def test_png_round_trip_and_refusals(tmp_path):
    img = _frames((37, 53), 1, seed=1)[0]
    images.write_png(tmp_path / "a.png", img)
    with Image.open(tmp_path / "a.png") as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(images.read_png(tmp_path / "a.png"), img)
    Image.fromarray(img).save(tmp_path / "pil.png")     # filtered rows
    with pytest.raises(ValueError, match="filter type 0"):
        images.read_png(tmp_path / "pil.png")
    with pytest.raises(ValueError, match="not a PNG"):
        images.read_png(_write(tmp_path / "x.png", b"GIF89a"))


def _write(path, data):
    path.write_bytes(data)
    return path


def test_make_gif_from_files(tmp_path):
    frames = _frames((20, 30), 3, seed=2)
    (tmp_path / "pics").mkdir()
    for i, f in enumerate(frames[::-1]):
        images.write_png(tmp_path / "pics" / f"{2 - i:03d}.png", f)
    tutils.make_gif_from_files(tmp_path / "pics", tmp_path, "m")
    pal = images.palette()
    with Image.open(tmp_path / "m.gif") as im:
        assert im.n_frames == 3
        for i, f in enumerate(frames):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          pal[images.quantize(f)])
    tutils.make_gif_from_numpy(frames[:1], tmp_path)
    assert images.gif_info(tmp_path / "movie.gif")["frames"] == 1
    Image.fromarray(frames[0]).save(tmp_path / "pics" / "003.jpg")
    with pytest.raises(ValueError, match="JPEG"):
        tutils.make_gif_from_files(tmp_path / "pics", tmp_path, "j")


def test_plot_loss_curve(tmp_path):
    losses = [5.0, 4.0, float("nan"), 2.0, 1.5]
    tutils.plot_loss_curve(tmp_path, losses)
    np.testing.assert_array_equal(np.load(tmp_path / "losses.npy"), losses)
    img = images.read_png(tmp_path / "loss_curve.png")
    assert img.shape == (900, 1200, 3)
    red = (img == np.array([193, 18, 33], np.uint8)).all(axis=-1)
    black = (img == 0).all(axis=-1)
    assert red.sum() > 1000 and black.sum() > 4000
    ys, xs = np.nonzero(red)
    # the first loss is the largest: the curve starts at the box's top left
    assert ys[xs == xs.min()].min() < ys[xs == xs.max()].min()
    tutils.plot_loss_curve(tmp_path, [3.0])          # one point, flat range
    assert images.read_png(tmp_path / "loss_curve.png").shape == (900, 1200, 3)


class _Recorder:
    """A stand-in env that records the facade calls utils.render makes."""
    substeps = 3

    def __init__(self):
        self.calls, self.cur = [], 0

    def reset(self):
        self.calls.append(("reset",))
        self.cur = 0

    def step(self, a):
        self.calls.append(("step", float(a)))
        self.cur += self.substeps

    def render(self, f):
        self.calls.append(("render", f))
        return np.full((2, 2, 3), f, np.uint8)


@pytest.mark.parametrize("action,n_steps,interval", [
    (np.arange(7.0), 7, 2), (np.arange(5.0), 5, 0), (None, 9, 4),
    (None, 3, 0)])
def test_render_matches_jax(action, n_steps, interval):
    envs = _Recorder(), _Recorder()
    frames = [m.render(e, action=action, n_steps=n_steps, interval=interval)
              for m, e in zip((jutils, tutils), envs)]
    assert envs[1].calls == envs[0].calls
    assert len(frames[1]) == len(frames[0]) > 0
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)
