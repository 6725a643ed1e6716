"""PyTorch port: the training data path (data/) against the JAX package.

- Splits and sampled batches are identical for one RandomState seed (the
  same numpy code on the same stream).
- pad_resize_pair and the dataset's decoded samples and labels are
  array-equal.
- Crop and flips are equal to the JAX per-sample functions when the port
  is handed the offsets and coins the JAX keys drew; colour jitter with
  the JAX factors agrees within 1e-6 (float32 in the same order).
- The port's own draws come from a torch.Generator, another stream than
  jax.random: they are held to their ranges and rates, not to JAX's bits.
"""
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from neuralbarkcalculator_tpu_torch.data import augment as ta
from neuralbarkcalculator_tpu_torch.data import sampling as ts
from torch_port_common import remove_tmp_path  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """4 images per wood type with duals (0/127/255), odd sizes."""
    root = tmp_path_factory.mktemp("dataroot")
    rng = np.random.default_rng(3)
    for wood_type in ("epinette_gelee", "epinette_non_gelee", "sapin"):
        for sub in ("samples", "duals"):
            (root / sub / wood_type).mkdir(parents=True)
        for i in range(4):
            h, w = 40 + 4 * i, 48
            img = (rng.random((h, w, 3)) * 200 + 30).astype(np.uint8)
            Image.fromarray(img).save(root / "samples" / wood_type /
                                      f"img{i}.bmp")
            dual = rng.choice([0, 127, 255], size=(h, w),
                              p=[0.6, 0.35, 0.05]).astype(np.uint8)
            Image.fromarray(dual, mode="L").save(root / "duals" / wood_type /
                                                 f"img{i}.png")
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def test_splits_and_batches_equal_jax():
    from neuralbarkcalculator_tpu.data import sampling as js

    rng = np.random.default_rng(0)
    targets = [rng.integers(0, 3, (8, 8)) for _ in range(31)]
    woods = [("epinette_gelee", "epinette_non_gelee", "sapin")[i % 3]
             for i in range(31)]
    want = js.get_splits(targets, woods, np.random.RandomState(42))
    got = ts.get_splits(targets, woods, np.random.RandomState(42))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    jr, tr = np.random.RandomState(5), np.random.RandomState(5)
    want_b = list(js.weighted_batch_iterator(want[3], 5, jr, 12))
    got_b = list(ts.weighted_batch_iterator(got[3], 5, tr, 12))
    assert len(got_b) == len(want_b) == len(want[3]) * 12 // 5
    for a, b in zip(got_b, want_b):
        np.testing.assert_array_equal(a, b)
    jp = js.PrioritizedSampler(10, 3, 12, np.random.RandomState(1))
    tp = ts.PrioritizedSampler(10, 3, 12, np.random.RandomState(1))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
        tp.update(a, 0.5)
        jp.update(b, 0.5)
    assert tp.stats() == jp.stats()


@pytest.mark.parametrize("shape,size", [((40, 48), 64), ((64, 64), 64),
                                        ((60, 50), 64)])
def test_pad_resize_pair_equals_jax(shape, size):
    from neuralbarkcalculator_tpu.data import augment as ja

    rng = np.random.default_rng(1)
    sample = rng.random((*shape, 3)).astype(np.float32)
    target = rng.integers(0, 3, shape).astype(np.int32)
    for got, want in zip(ta.pad_resize_pair(sample, target, size),
                         ja.pad_resize_pair(sample, target, size)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dataset_equals_jax(data_root):
    from neuralbarkcalculator_tpu.data import dataset as jd
    from neuralbarkcalculator_tpu_torch.data import dataset as td

    got, want = td.BarkDataset(data_root), jd.BarkDataset(data_root)
    assert len(got) == len(want) == 12
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert td.load_image("") is None
    assert td.decode_label(None, (3, 4)).shape == (3, 4)


def test_crop_and_flips_equal_jax_per_sample():
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.data import augment as ja

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    lab = rng.integers(0, 3, (48, 40), dtype=np.uint8)
    crop = 24
    for s in range(8):
        kc, kf = jax.random.split(jax.random.PRNGKey(s))
        want_i, want_l = ja.paired_random_crop(kc, jnp.asarray(img),
                                               jnp.asarray(lab), crop)
        want_i, want_l = ja.paired_flips(kf, want_i, want_l)
        # the offsets and coins those keys drew (augment.py:120-122, 132-134)
        ki, kj = jax.random.split(kc)
        oy = int(jax.random.randint(ki, (), 0, 48 - crop + 1))
        ox = int(jax.random.randint(kj, (), 0, 40 - crop + 1))
        kh, kv = jax.random.split(kf)
        fh, fv = bool(jax.random.bernoulli(kh)), bool(jax.random.bernoulli(kv))
        got_i, got_l = ta.gather_crops(
            torch.from_numpy(img)[None], torch.from_numpy(lab)[None],
            torch.tensor([0]), torch.tensor([oy]), torch.tensor([ox]),
            torch.tensor([fh]), torch.tensor([fv]), crop)
        np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_l[0].numpy(), np.asarray(want_l))


def test_color_jitter_equals_jax_with_its_factors():
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.data import augment as ja

    img = np.random.default_rng(3).random((16, 20, 3)).astype(np.float32)
    for s in range(6):
        key = jax.random.PRNGKey(s)
        want = np.asarray(ja.color_jitter(key, jnp.asarray(img), 0.1, 0.2))
        # the factors and order that key drew (augment.py:97-110)
        kb, ks, korder = jax.random.split(key, 3)
        fb = float(jax.random.uniform(kb, (), minval=0.9, maxval=1.1))
        fs = float(jax.random.uniform(ks, (), minval=0.8, maxval=1.2))
        order = bool(jax.random.bernoulli(korder))
        got = ta.color_jitter(torch.from_numpy(img)[None],
                              torch.tensor([fb]), torch.tensor([fs]),
                              torch.tensor([order]))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_draws_stay_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    p = ta.draw_augment_params(n, 100, 80, 32, 0.1, 0.2, gen)
    assert int(p["oy"].min()) == 0 and int(p["oy"].max()) == 100 - 32
    assert int(p["ox"].min()) == 0 and int(p["ox"].max()) == 80 - 32
    assert 0.9 <= float(p["fb"].min()) and float(p["fb"].max()) <= 1.1
    assert 0.8 <= float(p["fs"].min()) and float(p["fs"].max()) <= 1.2
    for coin in ("bright_first", "flip_h", "flip_v"):
        assert abs(float(p[coin].float().mean()) - 0.5) < 0.04, coin
    again = ta.draw_augment_params(n, 100, 80, 32, 0.1, 0.2,
                                   torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_gather_augment_batch_shapes_and_normalization():
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (5, 40, 40, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 3, (5, 40, 40),
                                           dtype=np.uint8))
    mean = torch.tensor([0.5, 0.4, 0.3])
    std = torch.tensor([0.2, 0.25, 0.3])
    imgs, labs = ta.gather_augment_batch(
        images, labels, torch.tensor([4, 0, 4]), 16, mean, std,
        torch.Generator().manual_seed(1))
    assert imgs.shape == (3, 16, 16, 3) and imgs.dtype == torch.float32
    assert labs.shape == (3, 16, 16) and labs.dtype == torch.int64
    raw = imgs * std + mean
    assert float(raw.min()) >= -1e-6 and float(raw.max()) <= 1 + 1e-6
    assert set(labs.unique().tolist()) <= {0, 1, 2}
