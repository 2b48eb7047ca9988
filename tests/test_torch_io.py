"""The port's host I/O against the JAX package: the native loader (built
with g++ into the port's ``_build/``) on TIFF stacks and PGM / TIFF
sequences written with PIL, the sequence and renaming helpers, and the
interop converters.

Tolerances: decoding and the converters that do not blur are exact (the
same integer or float arithmetic).  The converters that blur run the
port's blur in float32 on float32 movies, against the JAX package's blur
of the same float32 movie: equal to 1e-5 relative.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import os

import numpy as np
import pytest
import scipy.io

from opticalflow_tpu.io import interop as jinterop
from opticalflow_tpu.io import native_loader as jnative
from opticalflow_tpu.io import sequences as jseq
from opticalflow_tpu_torch.io import interop, native_loader, sequences
from opticalflow_tpu_torch.ops.blur import blur_to_host

Image = pytest.importorskip("PIL.Image")


def _write_multipage_tiff(path, movie, mode=None):
    frames = [Image.fromarray(f, mode=mode) for f in movie]
    frames[0].save(path, save_all=True, append_images=frames[1:], compression=None)


def test_native_loader_builds_into_the_ports_build_directory():
    assert native_loader.available()
    lib = native_loader.load_library()
    assert lib._name == native_loader.LIB_PATH
    assert os.path.dirname(lib._name).endswith(os.path.join("opticalflow_tpu_torch", "_build"))
    assert lib.ofl_version() == 1


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_multipage_tiff_matches_jax_loader(tmp_path, dtype):
    rng = np.random.default_rng(0)
    if dtype == np.float32:
        movie = (rng.random((4, 37, 53)) * 1000.0).astype(np.float32)
    else:
        movie = rng.integers(0, 255 if dtype == np.uint8 else 60000, size=(4, 37, 53)).astype(dtype)
    path = str(tmp_path / "stack.tif")
    _write_multipage_tiff(path, movie, "F" if dtype == np.float32 else None)
    ours = native_loader.read_tiff_movie_native(path)
    assert ours.dtype == np.float32 and ours.shape == (4, 37, 53)
    np.testing.assert_array_equal(ours, movie.astype(np.float32))
    np.testing.assert_array_equal(ours, jnative.read_tiff_movie_native(path))
    # the float64 stack the drivers read, through io.sequences
    np.testing.assert_array_equal(sequences.read_tiff_movie(path), jseq.read_tiff_movie(path))
    for n in (2, 9):  # max_frames below and above the page count
        np.testing.assert_array_equal(native_loader.read_tiff_movie_native(path, max_frames=n),
                                      jnative.read_tiff_movie_native(path, max_frames=n))


@pytest.mark.parametrize("suffix", ["tif", "pgm"])
def test_sequence_matches_jax_loader(tmp_path, suffix):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, size=(6, 21, 34)).astype(np.uint8)
    paths = []
    for k, frame in enumerate(frames):
        p = str(tmp_path / f"f{k}.{suffix}")
        Image.fromarray(frame).save(p)
        paths.append(p)
    ours = native_loader.read_sequence_native(paths)
    np.testing.assert_array_equal(ours, frames.astype(np.float32))
    np.testing.assert_array_equal(ours, jnative.read_sequence_native(paths))
    np.testing.assert_array_equal(sequences.read_image_sequence_as_movie(str(tmp_path)),
                                  jseq.read_image_sequence_as_movie(str(tmp_path)))


def test_corrupt_file_raises_value_error_and_python_readers_take_compressed_tiffs(tmp_path):
    bad = tmp_path / "bad.tif"
    bad.write_bytes(b"this is not a tiff at all")
    with pytest.raises(ValueError):
        native_loader.read_tiff_movie_native(str(bad))
    with pytest.raises(ValueError):
        native_loader.read_sequence_native([str(bad)])
    # an LZW-compressed stack: the native loader refuses it, PIL reads it
    movie = np.random.default_rng(2).integers(0, 255, size=(3, 12, 10)).astype(np.uint8)
    path = str(tmp_path / "lzw.tif")
    frames = [Image.fromarray(f) for f in movie]
    frames[0].save(path, save_all=True, append_images=frames[1:], compression="tiff_lzw")
    with pytest.raises(ValueError):
        native_loader.read_tiff_movie_native(path)
    np.testing.assert_array_equal(sequences.read_tiff_movie(path), jseq.read_tiff_movie(path))
    np.testing.assert_array_equal(sequences.read_tiff_movie(path), movie)


def test_sequence_helpers_match_jax(tmp_path):
    names = ["frame10.png", "frame2.png", "frame1.png", "notes.txt", "a_3_b_1.png"]
    assert sequences.sort_filenames_numerically(names) == jseq.sort_filenames_numerically(names)
    assert [sequences.numerical_sort_key(n) for n in names] == [
        jseq.numerical_sort_key(n) for n in names]
    for sub in ("ours", "theirs"):
        src = tmp_path / sub / "src"
        src.mkdir(parents=True)
        for k, name in enumerate(["img_7_raw.png", "img_12_raw.png", "img_3_raw.png"]):
            (src / name).write_bytes(bytes([k]))
    assert (sequences.list_file_paths_in_folder_numerically(str(tmp_path / "ours" / "src"))
            == [p.replace("theirs", "ours") for p in jseq.list_file_paths_in_folder_numerically(
                str(tmp_path / "theirs" / "src"))])
    ours = sequences.rename_images(str(tmp_path / "ours" / "src"), str(tmp_path / "ours" / "dst"),
                                   "_raw")
    theirs = jseq.rename_images(str(tmp_path / "theirs" / "src"),
                                str(tmp_path / "theirs" / "dst"), "_raw")
    assert ours == theirs
    assert sorted(os.listdir(tmp_path / "ours" / "dst")) == sorted(
        os.listdir(tmp_path / "theirs" / "dst"))
    for dry_run in (True, False):
        assert (sequences.renumber_files(str(tmp_path / "ours" / "dst"), 5, dry_run=dry_run)
                == jseq.renumber_files(str(tmp_path / "theirs" / "dst"), 5, dry_run=dry_run))
    assert sorted(os.listdir(tmp_path / "ours" / "dst")) == sorted(
        os.listdir(tmp_path / "theirs" / "dst"))


def _cells(arrays):
    out = np.empty((len(arrays), 1), dtype=object)
    for k, a in enumerate(arrays):
        out[k, 0] = a
    return out


def _piv_mat(n_pairs, seed):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(3.0, 30.0, 6.0), np.arange(3.0, 30.0, 6.0), indexing="ij")
    u = [rng.normal(0.2, 0.05, gx.shape) for _ in range(n_pairs)]
    v = [rng.normal(0.1, 0.05, gx.shape) for _ in range(n_pairs)]
    u[0][1, 2] = np.nan  # a missing vector, dropped before interpolation
    return {"x": _cells([gx] * n_pairs), "y": _cells([gy] * n_pairs),
            "u_original": _cells(u), "v_original": _cells(v)}


def _movie(seed, shape=(4, 32, 32)):
    return (np.random.default_rng(seed).random(shape) * 40.0).astype(np.float32)


def test_piv_conversion_and_filter_match_jax(tmp_path):
    movie = _movie(3)
    path = str(tmp_path / "piv.mat")
    scipy.io.savemat(path, _piv_mat(3, 4))
    mat, jmat = interop.load_mat(path), jinterop.load_mat(path)
    ours = interop.convert_PIV_result(mat, movie, delta_x=0.5, delta_t=2.0)
    theirs = jinterop.convert_PIV_result(jmat, movie, delta_x=0.5, delta_t=2.0)
    assert set(ours) == set(theirs)
    for key in ours:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), err_msg=key)
    # the filter blurs: the same float32 movie blurred by each package
    for res in (ours, theirs):
        res["v_x"][0, :4] = 9.0  # unrealistic speeds, cut by the speed threshold
        res["speed"][0, :4] = 9.0
    interop.filter_PIV_flow_result(ours, intensity_threshold=20.0, speed_threshold=7.0,
                                   device="cpu")
    jinterop.filter_PIV_flow_result(theirs, intensity_threshold=20.0, speed_threshold=7.0)
    blurred = blur_to_host(movie, 3, "cpu")
    jblurred = np.asarray(jinterop.blur_movie(movie, 3))
    np.testing.assert_allclose(blurred, jblurred, rtol=1e-5)
    for key in ("v_x", "v_y", "speed"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-5, err_msg=key)
    assert (ours["speed"][0, :4] == 0).all() and (ours["v_x"] == 0).any()


def test_piv_vector_threshold_matches_jax():
    movie = _movie(5, (3, 40, 40)) * 3.0
    rng = np.random.default_rng(6)
    x = np.tile(np.arange(2.0, 18.0, 4.0)[None, :, None], (2, 1, 4))  # (frames, 4, 4) um
    y = np.tile(np.arange(2.0, 18.0, 4.0)[None, None, :], (2, 4, 1))
    args = [rng.normal(0.02, 0.03, (2, 4, 4)) for _ in range(3)]
    ours = [a.copy() for a in args]
    theirs = [a.copy() for a in args]
    interop.threshold_PIV_vectors(x, y, *ours, movie, delta_x=0.5, window_size=15,
                                  threshold=-2, device="cpu")
    jinterop.threshold_PIV_vectors(x, y, *theirs, movie, delta_x=0.5, window_size=15,
                                   threshold=-2)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert any((a == 0).any() for a in ours)


def test_dic_and_liu_converters_match_jax():
    rng = np.random.default_rng(7)
    disp, coords = rng.normal(size=(1, 2, 5, 6, 4)), rng.random((1, 2, 5, 6, 4)) * 50
    ours = interop.convert_mudic_result(disp, coords, delta_x=0.3, delta_t=2.0)
    theirs = jinterop.convert_mudic_result(disp, coords, delta_x=0.3, delta_t=2.0)
    assert set(ours) == set(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)

    displacements = [{"plot_u_dic": rng.normal(size=(6, 7)), "plot_v_dic": rng.normal(size=(6, 7)),
                      "plot_corrcoef_dic": rng.random((6, 7))} for _ in range(3)]
    ncorr = {"data_dic_save": {"displacements": displacements}}
    for a, b in zip(interop.convert_ncorr_result(ncorr, 0.3, 2.0, corrcoef_threshold=0.4),
                    jinterop.convert_ncorr_result(ncorr, 0.3, 2.0, corrcoef_threshold=0.4)):
        np.testing.assert_array_equal(a, b)

    single = {"ux": rng.normal(size=(8, 9)), "uy": rng.normal(size=(8, 9))}
    cells = {"u_original": _cells([rng.normal(size=(8, 9))] * 2),
             "v_original": _cells([rng.normal(size=(8, 9))] * 2)}
    for liu in (single, cells):
        ours = interop.convert_liu_result(liu, movie_shape=(3, 8, 9), delta_x=0.3, delta_t=2.0)
        theirs = jinterop.convert_liu_result(liu, movie_shape=(3, 8, 9), delta_x=0.3, delta_t=2.0)
        assert set(ours) == set(theirs)
        for key in ours:
            np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]))
    with pytest.raises(KeyError):
        interop.convert_liu_result({"other": 1})
    with pytest.raises(ValueError):
        interop.convert_liu_result(single, movie_shape=(2, 5, 5))
