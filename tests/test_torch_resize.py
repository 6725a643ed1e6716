"""PyTorch port: the bicubic operators and the fused upsample+argmax.

The port builds its resize operators with its own numpy code; they must be
array-equal to the JAX package's. ``upsample_argmax`` on CPU tensors runs
its plain version, which must equal the Pallas kernel in interpret mode on
the shapes of tests/test_pallas_kernels.py. The CUDA kernel itself needs a
card: its test here skips without one, and chip_smoke.py holds it against
the plain version at the main path's shapes.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("in_size,out_size", [
    (16, 128), (121, 968), (128, 1024), (112, 896), (4, 32), (7, 5)])
def test_bicubic_resize_matrix_equals_jax(in_size, out_size):
    from neuralbarkcalculator_tpu.ops import resize as jr
    from neuralbarkcalculator_tpu_torch.ops import resize as tr

    want = jr.bicubic_resize_matrix(in_size, out_size)
    got = tr.bicubic_resize_matrix(in_size, out_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("feat_h,out_h,pad_feat,pad_out", [
    (112, 896, 128, 1024), (121, 968, 128, 1024), (128, 1024, 128, 1024),
    (3, 20, 4, 32)])
def test_embedded_bicubic_rows_equals_jax(feat_h, out_h, pad_feat,
                                          pad_out):
    from neuralbarkcalculator_tpu.ops import resize as jr
    from neuralbarkcalculator_tpu_torch.ops import resize as tr

    want = jr.embedded_bicubic_rows(feat_h, out_h, pad_feat, pad_out)
    got = tr.embedded_bicubic_rows(feat_h, out_h, pad_feat, pad_out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tr.embedded_bicubic_rows(pad_feat + 1, out_h, pad_feat, pad_out)


def test_bicubic_upsample_ragged_matches_jax(rng):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops import resize as jr
    from neuralbarkcalculator_tpu_torch.ops import resize as tr

    x = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    ops = np.stack([tr.embedded_bicubic_rows(h * 8 // 64, h, 8, 64)
                    for h in (64, 48)])
    want = np.asarray(jr.bicubic_upsample_ragged(
        jnp.asarray(x), jnp.asarray(ops), 128))
    got = tr.bicubic_upsample_ragged(torch.from_numpy(x),
                                     torch.from_numpy(ops), 128).numpy()
    # float32 products summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _kernel_inputs(rng, b=2, f=32, wf=16, ow=128, oh=256,
                   heights=(250, 256)):
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        column_operator_t, embedded_bicubic_rows)

    feat = rng.normal(size=(b, f, wf, 3)).astype(np.float32)
    row_ops = np.stack([embedded_bicubic_rows(f * h // oh, h, f, oh)
                        for h in heights])
    return feat, row_ops, column_operator_t(wf, ow)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_upsample_argmax_plain_equals_pallas_interpret(seed):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.ops.pallas_kernels import (
        upsample_argmax as pallas_upsample_argmax)
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        LAUNCHES, upsample_argmax, upsample_argmax_plain)

    rng = np.random.default_rng(seed)
    feat, row_ops, colt = _kernel_inputs(rng)
    want = np.asarray(pallas_upsample_argmax(
        jnp.asarray(feat), jnp.asarray(row_ops), jnp.asarray(colt),
        out_w=colt.shape[1], interpret=True))
    args = [torch.from_numpy(a) for a in (feat, row_ops, colt)]
    before = LAUNCHES.count
    got = upsample_argmax(*args).numpy()
    assert LAUNCHES.count == before  # CPU tensors never launch the kernel
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(upsample_argmax_plain(*args).numpy(),
                                  got)
    assert np.all(got[0, 250:] == 0)  # rows past valid_h are class 0


def test_upsample_argmax_ties_go_to_the_lower_class():
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax)

    feat = torch.zeros((1, 2, 2, 3))
    feat[0, 0, 0] = torch.tensor([1.0, 1.0, 0.0])  # 0 and 1 tie
    feat[0, 0, 1] = torch.tensor([0.0, 2.0, 2.0])  # 1 and 2 tie
    eye = torch.eye(2)
    out = upsample_argmax(feat, eye[None].contiguous(), eye)
    assert out[0, 0].tolist() == [0, 1]
    assert out[0, 1].tolist() == [0, 0]  # all-zero row: class 0


def test_upsample_argmax_rejects_bad_inputs():
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        upsample_argmax)

    feat = torch.zeros((1, 4, 4, 3))
    rows = torch.zeros((1, 8, 4))
    colt = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        upsample_argmax(feat.double(), rows, colt)
    with pytest.raises(ValueError):
        upsample_argmax(feat[:, :, :, :2], rows, colt)
    with pytest.raises(ValueError):
        upsample_argmax(feat, rows[:, :, :3], colt)
    with pytest.raises(ValueError):
        upsample_argmax(feat.transpose(1, 2), rows, colt)
    with pytest.raises(ValueError):
        upsample_argmax(feat, rows, torch.zeros((5, 8)))


@pytest.mark.cuda
def test_upsample_argmax_kernel_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs it at the main path's shapes)")
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        LAUNCHES, upsample_argmax, upsample_argmax_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).cuda() for a in _kernel_inputs(rng)]
    before = LAUNCHES.count
    got = upsample_argmax(*args)
    assert LAUNCHES.count == before + 1
    torch.testing.assert_close(got, upsample_argmax_plain(*args), rtol=0,
                               atol=0)
