"""PyTorch port: fused dropout + 1x1 conv (ops/fused_dropout_matmul.py).

Mirrors tests/test_pallas_kernels.py:46-81, whose JAX function needs the
TPU's on-core PRNG and cannot run on a CPU: on the CPU the port's wrapper
runs its plain version, which regenerates the same Philox mask in forward
and backward. The inputs are drawn with numpy in the JAX layout
[B, Hf, Wf, C]; the port takes NCHW. Tolerances: 1e-5 of max|y| against
the JAX einsum (two frameworks' sums over 512 channels, |y| up to ~80, in
different orders); the gradients equal
autodiff of the same function with the mask materialized, exactly for dh
and db, and for dw (a sum over all 4096 pixels of each image, in another
order) within 1e-5 of max|dw|.
"""
import numpy as np
import pytest
import torch

from neuralbarkcalculator_tpu_torch.ops import fused_dropout_matmul as fdm

SEED = 1234


def _inputs(rng, shape=(2, 32, 64, 512), k=3):
    h = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1], k)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    return h, w, b


def _nchw(h: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(h).permute(0, 3, 1, 2).contiguous()


def test_rate_zero_equals_jax_einsum():
    import jax.numpy as jnp

    h, w, b = _inputs(np.random.default_rng(0))
    want = np.asarray(jnp.einsum("bhwc,ck->bhwk", h, w) + b)
    got = fdm.fused_dropout_matmul(_nchw(h), torch.from_numpy(w),
                                   torch.from_numpy(b), SEED, 0.0)
    err = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max()


def test_rate_zero_mask_is_exact_identity():
    mask = fdm.dropout_mask((2, 8, 16, 16), SEED, 0.0)
    assert bool((mask == 1.0).all())
    assert fdm.keep_threshold(0.0) == 2 ** 32


@pytest.mark.parametrize("rate", [1e-9, 0.1, 0.5, 0.8])
def test_keep_threshold_is_the_pallas_formula(rate):
    assert fdm.keep_threshold(rate) == min(int((1.0 - rate) * 2 ** 32),
                                           2 ** 32 - 1)
    assert fdm.keep_scale(rate) == float(np.float32(1.0 / (1.0 - rate)))


@pytest.mark.parametrize("rate", [-0.1, 1.0])
def test_rate_out_of_range_raises(rate):
    with pytest.raises(ValueError):
        fdm.keep_threshold(rate)


def test_mask_values_and_keep_fraction():
    h, _, b = _inputs(np.random.default_rng(1))
    ht = _nchw(h).requires_grad_(True)
    ones_w = torch.ones(512, 3)
    fdm.fused_dropout_matmul(ht, ones_w, torch.from_numpy(b), SEED,
                             0.8).sum().backward()
    m = ht.grad / 3.0
    assert set(np.unique(m.numpy()).tolist()) <= {0.0, 5.0}
    assert 0.18 < float((m > 0).float().mean()) < 0.22


def test_mask_is_the_same_in_forward_and_backward():
    h, w, b = _inputs(np.random.default_rng(2))
    ht, wt, bt = _nchw(h).requires_grad_(True), torch.from_numpy(w), \
        torch.from_numpy(b)
    y = fdm.fused_dropout_matmul(ht, torch.ones(512, 3), bt, SEED, 0.8)
    y.sum().backward()
    m_bwd = ht.grad / 3.0
    y2 = fdm.fused_dropout_matmul(ht.detach(), wt, bt, SEED, 0.8)
    want = torch.einsum("bchw,ck->bkhw", ht.detach() * m_bwd, wt) + \
        bt.view(1, -1, 1, 1)
    assert torch.equal(y2, want)


def test_gradients_equal_materialized_mask_oracle():
    rng = np.random.default_rng(3)
    h, w, b = _inputs(rng)
    g = torch.from_numpy(rng.standard_normal((2, 3, 32, 64)).astype(
        np.float32))
    args = [_nchw(h), torch.from_numpy(w), torch.from_numpy(b)]
    got_in = [a.clone().requires_grad_(True) for a in args]
    fdm.fused_dropout_matmul(*got_in, SEED, 0.8).backward(g)

    m = fdm.dropout_mask(args[0].shape, SEED, 0.8)
    want_in = [a.clone().requires_grad_(True) for a in args]
    y = torch.einsum("bchw,ck->bkhw", want_in[0] * m, want_in[1]) + \
        want_in[2].view(1, -1, 1, 1)
    y.backward(g)
    assert torch.equal(got_in[0].grad, want_in[0].grad)   # dh
    assert torch.equal(got_in[2].grad, want_in[2].grad)   # db
    dw_err = (got_in[1].grad - want_in[1].grad).abs().max()
    assert dw_err <= 1e-5 * want_in[1].grad.abs().max()    # dw


def test_mask_is_deterministic_per_seed_and_differs_across_seeds():
    shape = (2, 16, 32, 32)
    a = fdm.dropout_mask(shape, SEED, 0.8)
    assert torch.equal(a, fdm.dropout_mask(shape, SEED, 0.8))
    for other in (SEED + 1, SEED + 2 ** 32, 2 ** 64 - 1):
        differ = float((a != fdm.dropout_mask(shape, other, 0.8)).float()
                       .mean())
        assert differ > 0.2, other


def test_philox_known_answer_and_bigint_reference():
    """Random123's known answer for counter 0 and key 0, and a Python
    big-integer Philox4x32-10 for random counters and keys."""
    got = fdm.philox4x32_10(torch.tensor([0]), 0)[0].tolist()
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]

    mask32 = 0xFFFFFFFF

    def ref(ctr, key):
        c = [ctr & mask32, ctr >> 32, 0, 0]
        k = [key & mask32, key >> 32]
        for _ in range(10):
            p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask32,
                 (p0 >> 32) ^ c[3] ^ k[1], p0 & mask32]
            k = [(k[0] + 0x9E3779B9) & mask32, (k[1] + 0xBB67AE85) & mask32]
        return c

    rng = np.random.default_rng(4)
    ctrs = [int(c) for c in rng.integers(0, 2 ** 62, 200)] + [2 ** 32 - 1]
    for key in (0, 7, 2 ** 63 + 5, 2 ** 64 - 1):
        got = fdm.philox4x32_10(torch.tensor(ctrs), key).tolist()
        assert got == [ref(c, key) for c in ctrs]


def test_mask_does_not_depend_on_the_tiling():
    """Element i's bits come from its linear index alone: the mask of a
    tensor is the prefix of the mask of any longer one."""
    small = fdm.dropout_mask((1, 3, 5, 7), SEED, 0.5).reshape(-1)
    big = fdm.dropout_mask((2, 3, 5, 7), SEED, 0.5).reshape(-1)
    assert torch.equal(small, big[:small.numel()])


@pytest.mark.parametrize("rows", [0, 1, 2, 4])
def test_offset_mask_is_the_global_masks_rows(rows):
    """A data-parallel rank's mask: at element offset rows * C * H * W,
    the mask of its rows [rows, 5) equals those rows of the offset-0 mask
    of the global [5, C, H, W] tensor, bit for bit."""
    shape = (5, 6, 4, 6)
    full = fdm.dropout_mask(shape, SEED, 0.8)
    chw = shape[1] * shape[2] * shape[3]
    got = fdm.dropout_mask((5 - rows, *shape[1:]), SEED, 0.8,
                           offset=rows * chw)
    assert torch.equal(got, full[rows:])


@pytest.mark.parametrize("offset", [4, 8, 1000, 2 ** 40])
def test_offset_mask_is_a_window_of_the_linear_mask(offset):
    """Any offset that is a multiple of 4 selects the window [offset,
    offset + n) of the linear mask; others are refused."""
    n = 96
    whole = fdm.dropout_mask((offset % 4096 + n,), SEED, 0.5,
                             offset=offset - offset % 4096)
    got = fdm.dropout_mask((n,), SEED, 0.5, offset=offset)
    assert torch.equal(got, whole[offset % 4096:])
    for bad in (offset + 2, -4):
        with pytest.raises(ValueError, match="offset"):
            fdm.dropout_mask((n,), SEED, 0.5, offset=bad)


def test_op_at_an_offset_is_the_global_ops_rows():
    """Forward and gradients of a rank's rows at its element offset equal
    the rows of the global batch's."""
    rng = np.random.default_rng(6)
    h, w, b = (torch.from_numpy(a) for a in _inputs(rng, (4, 8, 8, 16)))
    h = h.permute(0, 3, 1, 2).contiguous()
    g = torch.from_numpy(rng.standard_normal((4, 3, 8, 8)).astype(
        np.float32))
    y = fdm.fused_dropout_matmul_plain(h, w, b, SEED, 0.8)
    dh, _, _ = fdm.fused_dropout_matmul_backward_plain(h, w, g, SEED, 0.8)
    offset = 2 * h[0].numel()
    y2 = fdm.fused_dropout_matmul(h[2:].contiguous(), w, b, SEED, 0.8,
                                  offset=offset)
    dh2, _, _ = fdm.fused_dropout_matmul_backward(h[2:].contiguous(), w,
                                                  g[2:], SEED, 0.8, offset)
    torch.testing.assert_close(y2, y[2:], rtol=1e-6, atol=1e-6)
    assert torch.equal(dh2 == 0, dh[2:] == 0)
    torch.testing.assert_close(dh2, dh[2:], rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    h = torch.zeros(1, 8, 4, 4)
    w, b = torch.zeros(8, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="contiguous"):
        fdm.fused_dropout_matmul(h.permute(0, 1, 3, 2), w, b, SEED, 0.5)
    with pytest.raises(TypeError):
        fdm.fused_dropout_matmul(h.double(), w, b, SEED, 0.5)
    with pytest.raises(ValueError):
        fdm.fused_dropout_matmul(h, torch.zeros(7, 3), b, SEED, 0.5)
    with pytest.raises(ValueError):
        fdm.fused_dropout_matmul(h, w, b, -1, 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        fdm.fused_dropout_matmul_forward(h.to("meta"), w.to("meta"),
                                         b.to("meta"), SEED, 0.5)
    # the kernels' shape limits, refused before the library is loaded
    with pytest.raises(ValueError, match="H\\*W % 4"):
        fdm._kernel_args(torch.zeros(1, 8, 3, 5), w, SEED, 0.5)
    with pytest.raises(ValueError, match="at least 1 output channel"):
        fdm._kernel_args(h, torch.zeros(8, 0), SEED, 0.5)
    # the kernels read h and g as float4: a view one float into its storage
    # is refused before a launch
    fdm._check_aligned(h=h, g=torch.zeros(1, 3, 4, 4))
    for name in ("h", "g"):
        with pytest.raises(ValueError, match=f"{name} must be 16-byte"):
            fdm._check_aligned(**{name: torch.zeros(49)[1:].view(1, 3, 4, 4)})


def test_head_runs_the_op_only_in_train_mode(monkeypatch):
    from neuralbarkcalculator_tpu_torch.models import heads

    calls = []

    def spy(*args, offset):
        calls.append((*args[3:], offset))
        return fdm.fused_dropout_matmul(*args, offset=offset)

    monkeypatch.setattr(heads, "fused_dropout_matmul", spy)
    torch.manual_seed(0)
    head = heads.FCNHead(64, 3, dropout=0.8)
    x = torch.randn(2, 64, 8, 8)
    head.eval()
    with torch.no_grad():
        y_eval = head(x)
    assert calls == []
    head.train()
    with pytest.raises(ValueError, match="dropout_seed"):
        head(x)
    y = head(x, dropout_seed=SEED)
    assert calls == [(SEED, 0.8, 0)]  # one process: the mask at element 0
    with torch.no_grad():
        a = head[2](head[1](head[0](x)))
        want = fdm.fused_dropout_matmul_plain(
            a, head[4].weight.view(3, 16).t(), head[4].bias, SEED, 0.8)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert y.shape == y_eval.shape == (2, 3, 8, 8)
    assert set(head.state_dict()) == {
        "0.weight", "1.weight", "1.bias", "1.running_mean", "1.running_var",
        "1.num_batches_tracked", "4.weight", "4.bias"}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2])
def test_kernels_take_the_offset_on_card(rows):
    """The kernels at a rank's element offset equal the plain versions
    there, and their mask is those rows of the global batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py runs them at the training path's "
                    "shapes and offsets)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    h, w, b = (torch.from_numpy(a).cuda() for a in _inputs(
        rng, (3, 16, 64, 64), 3))
    h = h.permute(0, 3, 1, 2).contiguous()
    g = torch.from_numpy(rng.standard_normal((3, 3, 16, 64)).astype(
        np.float32)).cuda()
    offset = rows * h[0].numel()
    part, g_part = h[rows:].contiguous(), g[rows:].contiguous()
    y = fdm.fused_dropout_matmul_forward(part, w, b, SEED, 0.8, offset)
    torch.testing.assert_close(y, fdm.fused_dropout_matmul_plain(
        part, w, b, SEED, 0.8, offset), rtol=1e-5, atol=1e-5)
    dh, _, _ = fdm.fused_dropout_matmul_backward(part, w, g_part, SEED, 0.8,
                                                 offset)
    full = fdm.dropout_mask(h.shape, SEED, 0.8, device="cuda")
    assert torch.equal(dh == 0, full[rows:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,rate", [
    ((2, 8, 16, 64), 3, 0.8),
    # [B, H, W, C] that miss every tile of the kernels: 72 channels, 3600
    # pixels; each class count the kernels are built for but 2, rate 0
    # (the identity) and the recipe's
    *[((1, 60, 60, 72), k, rate) for k in (1, 3, 4) for rate in (0.0, 0.8)],
])
def test_kernels_equal_plain_on_card(shape, k, rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py runs them at the training path's "
                    "shapes)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    h, w, b = (torch.from_numpy(a).cuda() for a in _inputs(rng, shape, k))
    h = h.permute(0, 3, 1, 2).contiguous()
    g = torch.from_numpy(rng.standard_normal(
        (shape[0], k, shape[1], shape[2])).astype(np.float32)).cuda()
    before = (fdm.FWD_LAUNCHES.count, fdm.BWD_LAUNCHES.count)
    y = fdm.fused_dropout_matmul_forward(h, w, b, SEED, rate)
    dh, dw, db = fdm.fused_dropout_matmul_backward(h, w, g, SEED, rate)
    assert (fdm.FWD_LAUNCHES.count, fdm.BWD_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, fdm.fused_dropout_matmul_plain(
        h, w, b, SEED, rate), rtol=1e-5, atol=1e-5)
    dh_p, dw_p, db_p = fdm.fused_dropout_matmul_backward_plain(h, w, g, SEED,
                                                               rate)
    assert torch.equal(dh == 0, dh_p == 0)
    torch.testing.assert_close(dh, dh_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-4)
    # db is summed inside the backward kernel from the g quads it already
    # holds (per lane, across lanes, then per-block rows in order), so the
    # wrapper launches no torch sum; torch sums g in its own order. They
    # differ by float32 rounding only, hence a tolerance and not equality;
    # 1e-5 still fails on a single missing pixel quad.
    torch.testing.assert_close(db, db_p, rtol=1e-5, atol=1e-5)
    # a second call gives the same bits
    assert torch.equal(y, fdm.fused_dropout_matmul_forward(h, w, b, SEED,
                                                           rate))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        (dh, dw, db), fdm.fused_dropout_matmul_backward(h, w, g, SEED, rate)))
    with pytest.raises(ValueError, match="g must be 16-byte aligned"):
        fdm.fused_dropout_matmul_backward(
            h, w, torch.zeros(g.numel() + 1, device="cuda")[1:].view(g.shape),
            SEED, 0.8)
