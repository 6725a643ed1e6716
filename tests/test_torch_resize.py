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


def test_operator_windows():
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        operator_windows)

    op = torch.tensor([[0.0, 1.0, 0.0, 2.0, 0.0],    # zero inside: 1..4
                       [0.0, 0.0, 0.0, 0.0, 0.0],    # empty: (0, 0)
                       [3.0, 1.0, 1.0, 1.0, -1.0],   # dense: 0..5
                       [0.0, 0.0, 0.0, 0.0, -0.5]])
    lo, hi = operator_windows(op)
    assert lo.tolist() == [1, 0, 0, 4]
    assert hi.tolist() == [4, 0, 5, 5]
    lo, hi = operator_windows(op[None].expand(2, 4, 5))
    assert lo.shape == (2, 4) and hi[1].tolist() == [4, 0, 5, 5]


def test_column_windows_are_colt_column_windows():
    from neuralbarkcalculator_tpu_torch.ops.resize import column_operator_t
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        column_windows, operator_windows)

    colt = torch.from_numpy(column_operator_t(16, 128))
    colt[:, 5] = 0.0  # an all-zero column: the empty window (0, 0)
    win = column_windows(colt)
    assert win.dtype == torch.int32 and win.shape == (2, 128)
    assert win.is_contiguous()
    lo, hi = operator_windows(colt.t().contiguous())
    assert win[0].tolist() == lo.tolist() and win[1].tolist() == hi.tolist()
    assert win[:, 5].tolist() == [0, 0]


def test_upsample_argmax_takes_cached_column_windows(rng):
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        column_windows, upsample_argmax)

    args = [torch.from_numpy(a) for a in _kernel_inputs(rng)]
    want = upsample_argmax(*args)
    got = upsample_argmax(*args, column_windows(args[2]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    win = column_windows(args[2])
    for bad in (win.long(), win[:, :-1].contiguous(), win.t().contiguous(),
                win.t().contiguous().t()):
        with pytest.raises(ValueError):
            upsample_argmax(*args, bad)


def _assert_band(op: np.ndarray, valid: int) -> None:
    """Rows < valid have their nonzeros inside one window of 1..4
    contiguous entries; rows >= valid are all zero."""
    from neuralbarkcalculator_tpu_torch.ops.upsample_argmax import (
        operator_windows)

    lo, hi = (w.numpy() for w in operator_windows(torch.from_numpy(op)))
    width = hi[:valid] - lo[:valid]
    assert width.min() >= 1 and width.max() <= 4, (width.min(), width.max())
    assert not op[valid:].any() and not hi[valid:].any()


@pytest.mark.parametrize("first_height", range(1, 1025, 128))
def test_row_operators_have_the_bicubic_band(first_height):
    """The kernel's speed rests on each row operator row having <= 4
    contiguous nonzeros: every trimmed height of the 1024 bucket, as the
    engine builds them (first_height .. first_height + 127)."""
    from neuralbarkcalculator_tpu_torch.models.resnet import resnet50_dilated
    from neuralbarkcalculator_tpu_torch.ops.resize import (
        embedded_bicubic_rows)

    with torch.device("meta"):
        backbone = resnet50_dilated()
    for h in range(first_height, first_height + 128):
        op = embedded_bicubic_rows(backbone.valid_feature_height(h), h,
                                   1024 // 8, 1024)
        _assert_band(op, h)


@pytest.mark.parametrize("width", [256, 512, 1024, 2048])
def test_width_operator_has_the_bicubic_band(width):
    from neuralbarkcalculator_tpu_torch.ops.resize import column_operator_t

    colt = column_operator_t(width // 8, width)
    _assert_band(np.ascontiguousarray(colt.T), width)


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

    # dense operators: the kernel finds whole-axis windows (odd F and OW
    # take its scalar copy and byte store paths); logits ~ N(0, 1), so a
    # pixel may differ only at a float32 near-tie (margin < 1e-5)
    b, oh, f, wf, ow = 2, 70, 23, 20, 200
    feat = rng.standard_normal((b, f, wf, 3), dtype=np.float32)
    # np.float32 divisors: a float64 scalar would promote the arrays to
    # float64 under numpy 2, which the kernel refuses
    rows = rng.standard_normal((b, oh, f), dtype=np.float32) / np.float32(
        np.sqrt(f))
    colt = rng.standard_normal((wf, ow), dtype=np.float32) / np.float32(
        np.sqrt(wf))
    args = [torch.from_numpy(a).cuda() for a in (feat, rows, colt)]
    got = upsample_argmax(*args)
    want = upsample_argmax_plain(*args)
    logits = torch.einsum("bof,bfwc,wp->bcop", args[1], args[0], args[2])
    top2 = logits.topk(2, dim=1).values
    differ = got != want
    assert not differ.any() or float(
        (top2[:, 0] - top2[:, 1])[differ].max()) < 1e-5
