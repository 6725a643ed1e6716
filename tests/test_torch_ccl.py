"""PyTorch port: connected-component labelling and small-zone removal
(ops/ccl.py) against the JAX package's ``ops/ccl.py``, scipy.ndimage and
the native union-find.

On the CPU the port runs its plain version (the JAX package's sweep-and-
scan algorithm in torch ops). Every comparison is exact: labels are
integer flat indices and areas integer counts, so the labels, areas,
masks and class maps must be equal bit for bit. The card test holds the
union-find kernels (csrc/ccl.cu) against the plain version, also exactly.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from neuralbarkcalculator_tpu_torch.ops import ccl

_S8 = np.ones((3, 3), dtype=int)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain version runs thousands of small torch ops: intra-op
    threads only cost time there, and under the lane's parallel workers
    they oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax():
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import ccl as jccl
    return jnp, jccl


def _scipy_areas(mask: np.ndarray) -> np.ndarray:
    lab, n = ndi.label(mask, structure=_S8)
    counts = np.bincount(lab.ravel(), minlength=n + 1)
    counts[0] = 0
    return counts[lab]


def _blob_maps(rng, n, h, w, p0=0.5):
    """Class maps {0, 1, 2} shaped like real masks: coarse blocks with
    noise, so zones of every size appear, down to single pixels."""
    coarse = rng.random((n, h // 8 + 1, w // 8 + 1))
    field = np.kron(coarse, np.ones((1, 8, 8)))[:, :h, :w]
    field = field + 0.35 * rng.random((n, h, w))
    maps = np.where(field < p0 + 0.175, 0, 1)
    maps[(maps == 1) & (rng.random((n, h, w)) < 0.1)] = 2
    return maps.astype(np.int32)


def spiral(n: int) -> np.ndarray:
    """A one-component spiral of arm spacing 2 (the JAX package's worst
    case for sweep labelling, tests/test_ccl.py)."""
    grid = np.zeros((n, n), bool)
    top, bottom, left, right = 0, n - 1, 0, n - 1
    while left <= right and top <= bottom:
        grid[top, left:right + 1] = True
        grid[top:bottom + 1, right] = True
        grid[bottom, left:right + 1] = True
        if left + 2 <= right:
            grid[top:bottom + 1, left] = False
            grid[top + 2:bottom + 1, left + 2] = True
        top += 2
        bottom -= 2
        left += 2
        right -= 2
    return grid


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
@pytest.mark.parametrize("shape", [(17, 43), (32, 32)])
def test_label_components_equal_jax(density, shape):
    jnp, jccl = _jax()
    mask = np.random.default_rng(int(density * 10)).random(shape) < density
    want = np.asarray(jccl.label_components(jnp.asarray(mask)))
    got = ccl.label_components(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
def test_component_areas_equal_jax_and_scipy(density):
    jnp, jccl = _jax()
    masks = np.random.default_rng(7).random((3, 24, 40)) < density
    got = ccl.component_areas(torch.from_numpy(masks)).numpy()
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(
            got[i], np.asarray(jccl.component_areas(jnp.asarray(m))))
        np.testing.assert_array_equal(got[i], _scipy_areas(m))


@pytest.mark.parametrize("thr", [1, 5, 20, 150])
@pytest.mark.parametrize("op", ["objects", "holes"])
def test_remove_small_objects_and_holes_equal_jax(op, thr):
    jnp, jccl = _jax()
    rng = np.random.default_rng(thr)
    mask = _blob_maps(rng, 1, 48, 56)[0] == 0
    port = {"objects": ccl.remove_small_objects,
            "holes": ccl.remove_small_holes}[op]
    ref = {"objects": jccl.remove_small_objects,
           "holes": jccl.remove_small_holes}[op]
    got = port(torch.from_numpy(mask), thr)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref(jnp.asarray(mask), thr)))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int64])
def test_remove_small_zones_equal_jax(batched, dtype):
    jnp, jccl = _jax()
    maps = _blob_maps(np.random.default_rng(5), 3, 64, 80)
    want = np.asarray(jccl.remove_small_zones(jnp.asarray(maps)))
    x = maps.astype(dtype) if batched else maps[1].astype(dtype)
    got = ccl.remove_small_zones(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    assert (got.numpy() != x).any()  # the clean-up did work
    np.testing.assert_array_equal(got.numpy(),
                                  want if batched else want[1])


@pytest.mark.parametrize("valid_h", [(0, 64, 40), (64, 1, 33), (17, 0, 0)])
def test_remove_small_zones_ragged_equal_jax(valid_h):
    jnp, jccl = _jax()
    maps = _blob_maps(np.random.default_rng(11), 3, 64, 72)
    vh = np.array(valid_h, np.int32)
    want = np.asarray(jccl.remove_small_zones_ragged(jnp.asarray(maps),
                                                     jnp.asarray(vh)))
    got = ccl.remove_small_zones_ragged(torch.from_numpy(maps),
                                        torch.from_numpy(vh)).numpy()
    np.testing.assert_array_equal(got, want)
    for i, h in enumerate(valid_h):
        assert not got[i, h:].any()  # padded rows come back 0
    # one image with a scalar height
    np.testing.assert_array_equal(
        ccl.remove_small_zones_ragged(torch.from_numpy(maps[2]),
                                      valid_h[2]).numpy(), want[2])


def test_batch_images_do_not_merge():
    """Image 0's last row and image 1's first row are foreground, as are
    every row's last and the next row's first column: labelled as one
    image they would join; per image they must not."""
    jnp, jccl = _jax()
    masks = np.zeros((2, 6, 5), bool)
    masks[0, -1, :] = True
    masks[1, 0, :] = True
    masks[:, 2, -1] = True
    masks[:, 3, 0] = True
    got = ccl.label_components(torch.from_numpy(masks)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], np.asarray(jccl.label_components(jnp.asarray(masks[i]))))
    assert got[1, 0, 0] == 0 and got[0, -1, 0] == 25
    assert got[0, 2, -1] != got[0, 3, 0]  # a row end does not wrap
    areas = ccl.component_areas(torch.from_numpy(masks)).numpy()
    assert areas[0, -1, 0] == 5 and areas[1, 0, 0] == 5


def test_spiral_equal_jax_and_scipy():
    jnp, jccl = _jax()
    grid = spiral(64)
    lab = ccl.label_components(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(
        lab, np.asarray(jccl.label_components(jnp.asarray(grid))))
    want, n = ndi.label(grid, structure=_S8)
    assert n == 1 and np.unique(lab[grid]).tolist() == [
        int(np.flatnonzero(grid.ravel())[0])]


def test_random_grids_equal_native_union_find():
    from neuralbarkcalculator_tpu_torch.io.native import (
        remove_small_zones_batch)

    maps = []
    for seed in range(6):
        r = np.random.default_rng(seed)
        p0 = 0.3 + 0.5 * r.random()
        maps.append(r.choice([0, 1, 2], size=(80, 96),
                             p=[p0, (1 - p0) * 0.8, (1 - p0) * 0.2]))
    maps = np.stack(maps).astype(np.uint8)
    vh = np.array([80, 0, 41, 79, 1, 80], np.int32)
    got = ccl.remove_small_zones(torch.from_numpy(maps)).numpy()
    np.testing.assert_array_equal(got, remove_small_zones_batch(maps))
    got = ccl.remove_small_zones_ragged(torch.from_numpy(maps),
                                        torch.from_numpy(vh)).numpy()
    np.testing.assert_array_equal(got, remove_small_zones_batch(maps, vh))


@pytest.mark.parametrize("fill", [0, 1, 2])
def test_uniform_maps(fill):
    """All class 0, all bark, all node: nothing to clean, and the masks'
    single components cover the image."""
    maps = np.full((2, 12, 20), fill, np.uint8)
    got = ccl.remove_small_zones(torch.from_numpy(maps)).numpy()
    np.testing.assert_array_equal(got, maps)
    areas = ccl.component_areas(torch.from_numpy(maps == 0)).numpy()
    np.testing.assert_array_equal(areas, np.where(maps == 0, 240, 0))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 5), dtype=torch.int16)
    with pytest.raises(TypeError):
        ccl.remove_small_zones(x)
    with pytest.raises(TypeError):
        ccl.label_components(torch.zeros((4, 5)))
    with pytest.raises(ValueError):
        ccl.remove_small_zones(torch.zeros((2, 3, 4, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        ccl.remove_small_zones_ragged(torch.zeros((2, 4, 5), dtype=torch.uint8),
                                      torch.tensor([4]))
    with pytest.raises(ValueError):
        ccl.remove_small_zones_ragged(torch.zeros((2, 4, 5), dtype=torch.uint8),
                                      torch.tensor([4.0, 2.0]))
    with pytest.raises(ValueError):
        ccl.component_areas(torch.zeros((4, 5), dtype=torch.bool,
                                        device="meta"))
    # the kernels read a CUDA map in place (the card test holds that they
    # refuse a view); on the CPU the plain version takes views
    view = torch.from_numpy(np.random.default_rng(4).choice(
        3, size=(2, 9, 7)).astype(np.uint8)).transpose(1, 2)
    assert torch.equal(ccl.remove_small_zones(view),
                       ccl.remove_small_zones(view.contiguous()))
    mask = view[:, ::2] == 0
    assert torch.equal(ccl.label_components(mask),
                       ccl.label_components(mask.contiguous()))
    # labels are int32 per-image flat indices with H * W as the background
    with pytest.raises(ValueError, match="int32"):
        ccl.label_components(torch.zeros((46341, 46341), dtype=torch.bool,
                                          device="meta"))
    before = ccl.LAUNCHES.count
    ccl.remove_small_zones(torch.zeros((4, 5), dtype=torch.uint8))
    assert ccl.LAUNCHES.count == before  # the plain version counts nothing


def _scipy_labels(mask: np.ndarray) -> np.ndarray:
    """label_components' contract from scipy: each 8-connected component
    at its smallest flat index, H * W on the background."""
    lab, n = ndi.label(mask, structure=_S8)
    smallest = np.full(n + 1, mask.size, np.int32)
    ids, first = np.unique(lab.ravel(), return_index=True)
    smallest[ids[ids > 0]] = first[ids > 0]  # raster order
    return smallest[lab]


_TILE = (32, 128)  # csrc/ccl.cu's kTileH x kTileW


def _border_maps(name: str):
    """Small class maps that stress the kernels' tile borders, with their
    valid_h or None."""
    th, tw = _TILE
    rng = np.random.default_rng(3)
    if name.startswith("random"):
        h, w = (int(v) for v in name.split()[1].split("x"))
        return rng.choice(3, size=(2, h, w), p=[0.5, 0.4, 0.1]), None
    h, w = 2 * th + 5, 2 * tw + 3
    rows, cols = np.indices((h, w))
    corners = [(r, c) for r in range(0, h, th) for c in range(0, w, tw)]
    if name == "checkerboard":
        return np.where((rows + cols) % 2 == 0, 0, 1)[None], None
    if name == "diagonals":
        diag = np.zeros((h, w), bool)
        for r, c in corners:
            diag |= (cols - rows == c - r) | (cols + rows == c + r)
        return np.stack([np.where(diag, 0, 1), np.where(diag, 1, 0)]), None
    if name == "tile corners":
        lone = np.ones((h, w), np.int64)
        for r, c in corners:
            for rr, cc in ((r, c), (r, c + tw - 1), (r + th - 1, c),
                           (r + th - 1, c + tw - 1)):
                if rr < h and cc < w:
                    lone[rr, cc] = 0
        return np.stack([lone, 1 - lone]), None
    assert name == "ragged"
    return (rng.choice(3, size=(3, h, w), p=[0.5, 0.4, 0.1]),
            np.array([0, 1, h], np.int32))


_BORDER_MAPS = ["random 33x129", "random 1x300", "random 300x1",
                "random 70x260", "checkerboard", "diagonals",
                "tile corners", "ragged"]


@pytest.mark.parametrize("name", _BORDER_MAPS)
def test_border_maps_plain_equal_scipy_and_native(name):
    """The maps the card test holds the kernels to: the plain version's
    labels equal scipy's, its clean-up the native union-find's."""
    from neuralbarkcalculator_tpu_torch.io.native import (
        remove_small_zones_batch)

    maps, vh = _border_maps(name)
    x = torch.from_numpy(maps.astype(np.uint8))
    for m in (maps == 0, maps != 0):
        got = ccl.label_components(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got,
                                      np.stack([_scipy_labels(i) for i in m]))
    got = (ccl.remove_small_zones(x) if vh is None else
           ccl.remove_small_zones_ragged(x, torch.from_numpy(vh)))
    np.testing.assert_array_equal(got.numpy(),
                                  remove_small_zones_batch(x.numpy(), vh))


@pytest.mark.cuda
@pytest.mark.parametrize("name", _BORDER_MAPS)
def test_ccl_kernels_on_border_maps_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py runs them at the main path's shapes)")
    maps, vh = _border_maps(name)
    x = torch.from_numpy(maps).cuda()
    for m in (x == 0, x != 0):
        lab = ccl.label_components(m)
        assert torch.equal(lab, ccl.label_components_plain(m))
        assert torch.equal(ccl.component_areas(m),
                           ccl.component_areas_plain(m, lab))
    if vh is None:
        got, want = (ccl.remove_small_zones(x),
                     ccl.remove_small_zones_plain(x, None))
    else:
        v = torch.from_numpy(vh).cuda()
        got, want = (ccl.remove_small_zones_ragged(x, v),
                     ccl.remove_small_zones_plain(x, v))
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_ccl_kernels_equal_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py runs them at the main path's shapes)")
    maps = torch.from_numpy(_blob_maps(np.random.default_rng(2), 4, 192,
                                       200)).cuda()
    masks = maps == 0
    vh = torch.tensor([192, 0, 101, 7], dtype=torch.int32)
    before = ccl.LAUNCHES.count
    checks = [
        (ccl.label_components(masks), ccl.label_components_plain(masks)),
        (ccl.component_areas(masks), ccl.component_areas_plain(masks)),
        (ccl.remove_small_zones(maps),
         ccl.remove_small_zones_plain(maps, None)),
        (ccl.remove_small_zones_ragged(maps, vh),
         ccl.remove_small_zones_plain(maps, vh.cuda())),
        (ccl.remove_small_objects(masks, 40),
         masks & (ccl.component_areas_plain(masks) >= 40)),
        (ccl.remove_small_holes(masks, 40),
         ~(~masks & (ccl.component_areas_plain(~masks) >= 40))),
    ]
    torch.cuda.synchronize()
    assert ccl.LAUNCHES.count == before + len(checks)
    for got, want in checks:
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        ccl.remove_small_zones(maps.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ccl.label_components(masks[:, :, ::2])
    grid = torch.from_numpy(spiral(256)).cuda()
    lab = ccl.label_components(grid)
    first = int(np.flatnonzero(spiral(256).ravel())[0])
    assert lab[grid].unique().tolist() == [first]
