"""The port's ``blur_movie`` and ``blur_frame`` against the JAX package's.

Both take a numpy array or a tensor (the port) / any array (JAX), blur
integer movies in float32 and float ones in their own type.  Tolerances:
float64 input, the same taps summed in another order, 1e-12 relative;
float32 (and integer input, blurred in float32), ~1e-6 relative for the
float32 sums in another order (JAX convolves, the port adds shifted
slices), held to 2e-6 of the largest value.
"""

import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import blur as jblur
from opticalflow_tpu_torch import blur_movie as exported_blur_movie
from opticalflow_tpu_torch.ops import blur

F64_REL, F32_REL = 1e-12, 2e-6


def _movie(kind, shape):
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 4096, size=shape)
    return {"float64": counts * 0.37, "float32": (counts * 0.37).astype(np.float32),
            "uint16": counts.astype(np.uint16), "int32": counts.astype(np.int32)}[kind]


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind", ["float64", "float32", "uint16", "int32"])
@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_blur_movie_takes_numpy_and_matches_jax(kind, sigma):
    movie = _movie(kind, (3, 40, 56))
    got = blur.blur_movie(movie, sigma, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == (torch.float64 if kind == "float64" else torch.float32)
    _close(got.numpy(), jblur.blur_movie(movie, sigma), F64_REL if kind == "float64" else F32_REL)


@pytest.mark.parametrize("kind", ["float64", "float32", "uint16"])
def test_blur_movie_takes_a_tensor_where_it_lies(kind):
    movie = _movie(kind, (2, 33, 47))
    got = blur.blur_movie(torch.from_numpy(movie), 2.0)  # no device: a tensor stays put
    assert got.device.type == "cpu"
    _close(got.numpy(), jblur.blur_movie(movie, 2.0), F64_REL if kind == "float64" else F32_REL)


def test_exported_blur_movie_takes_numpy():
    movie = _movie("float32", (2, 24, 24))
    _close(exported_blur_movie(movie, 1.5, device="cpu").numpy(),
           jblur.blur_movie(movie, 1.5), F32_REL)


def test_blur_movie_array_without_device_needs_the_card(monkeypatch):
    """An array with ``device=None`` goes to the card, as every entry
    point's does; without CUDA that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blur.blur_movie(_movie("float32", (1, 8, 8)), 1.0)


@pytest.mark.parametrize("kind", ["float64", "uint16"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_blur_frame_matches_jax(kind, as_tensor):
    frame = _movie(kind, (45, 38))
    arg = torch.from_numpy(frame) if as_tensor else frame
    got = blur.blur_frame(arg, 2.5, device="cpu")
    assert got.shape == frame.shape
    _close(got.numpy(), jblur.blur_frame(frame, 2.5), F64_REL if kind == "float64" else F32_REL)
