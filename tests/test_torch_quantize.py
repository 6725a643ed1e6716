"""PyTorch port: int8 post-training quantization against the JAX package
(models/qops.py, models/quantize.py, the quantized ResNet / FCN / DeepLab
forwards).

Both packages take the same inputs, made with numpy. What must hold, and
to which tolerance:

- the epilogues (``requant_relu``, ``requant_signed``, ``dequant``,
  ``quantize_act``) equal numpy's separate float32 multiply and add and
  JAX's ``qops``, bit for bit;
- ``qconv`` (one ``torch._int_mm`` over an NHWC im2col) equals JAX's
  ``qconv`` (XLA's int8 conv) exactly, int32 for int32, at 1x1, 3x3 stride
  1 / 2, dilation 2 / 4 and the ASPP's rates 12 / 24 / 36 on maps smaller
  and larger than the rate;
- ``quantize_variables`` fed JAX's stats and the carried-over folded
  weights: every int8 weight, ``m`` and ``b`` bit-equal to JAX's, and the
  ``q_ds`` overflow warning where JAX's fires;
- ``calibrate``: JAX's keys, values within 1e-5 relative (float32);
- each quantized block and head, fed the same int8 input with the same
  int8 parameters, bit-equal to JAX's. The DeepLab pooled branch's float32
  product [B, cin] x [cin, 256] sums in another order than XLA's, so its
  int8 result may differ by 1 LSB: the test allows that and then feeds
  JAX's pooled branch to the port, which must give JAX's output bit for
  bit;
- the whole model from one post-stem int8 tensor bit-equal to JAX's
  blocks and head; ``head_logits`` with the float stem (which rounds
  differently in the two frameworks) within 2e-2 relative L2;
- a padded ragged batch equal to per-image runs bit for bit (FCN and
  DeepLab).
"""
import warnings

import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, normalized,
                               tiny_deeplab_jax_model,
                               tiny_deeplab_torch_model, tiny_jax_model,
                               tiny_torch_model, tiny_variables)

# a whole model's head_logits against JAX: the float stem rounds
# differently, which may move a few stem int8 values by 1 LSB
HEAD_LOGITS_REL_L2 = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _images(seed: int, n: int = 2, h: int = 64, w: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return normalized([blob_image(rng, h, w) for _ in range(n)])


def _port_state(qparams: dict) -> dict:
    from neuralbarkcalculator_tpu_torch.models.convert import (
        quantized_variables_to_state_dict)

    return quantized_variables_to_state_dict({"params": qparams})


# ----------------------------------------------------------- primitives

@pytest.mark.parametrize("name", ["requant_relu", "requant_signed",
                                  "dequant", "quantize_act"])
def test_epilogues_equal_numpy_and_jax(name):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models import qops as jq
    from neuralbarkcalculator_tpu_torch.models import qops as tq

    rng = np.random.default_rng(0)
    if name == "quantize_act":
        x = (rng.normal(0, 60, (2, 5, 6, 8))).astype(np.float32)
        inv = np.float32(0.37)
        want = np.clip(np.round(x * inv), -127, 127).astype(np.int8)
        got = tq.quantize_act(torch.from_numpy(x), torch.tensor(inv))
        jgot = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.float32(inv)))
        assert not tq.quantize_act(torch.zeros(1, 4, 4, 3),
                                   torch.tensor(37.0)).any()
    else:
        acc = rng.integers(-3_000_000, 3_000_000, (2, 4, 5, 8), np.int32)
        m = rng.uniform(1e-6, 1e-4, 8).astype(np.float32)
        b = rng.normal(0, 20, 8).astype(np.float32)
        y = acc.astype(np.float32) * m + b  # two float32 roundings
        lo = 0 if name == "requant_relu" else -127
        want = (y if name == "dequant"
                else np.clip(np.round(y), lo, 127).astype(np.int8))
        got = getattr(tq, name)(torch.from_numpy(acc), torch.from_numpy(m),
                                torch.from_numpy(b))
        jgot = np.asarray(getattr(jq, name)(jnp.asarray(acc), jnp.asarray(m),
                                            jnp.asarray(b)))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(jgot, want)


@pytest.mark.parametrize("k,stride,dilation,h,w,cout", [
    (1, 1, 1, 9, 7, 64),
    (1, 2, 1, 9, 7, 64),      # the downsample branch
    (3, 1, 1, 9, 7, 64),
    (3, 2, 1, 9, 7, 64),      # a stage's strided conv2
    (3, 1, 2, 9, 7, 64),      # layer3
    (3, 1, 4, 9, 7, 64),      # layer4
    (3, 1, 12, 8, 8, 64),     # the ASPP's rates past the map: centre tap
    (3, 1, 24, 8, 8, 64),
    (3, 1, 36, 8, 8, 64),
    (3, 1, 12, 20, 16, 64),   # a rate inside the map
    (3, 1, 36, 40, 30, 64),   # rows inside, columns past
    (1, 1, 1, 9, 7, 3),       # the classifier: N = 3, padded to 8
    (3, 1, 1, 2, 4, 16),      # 8 rows: padded past cuBLAS's 16-row floor
])
def test_qconv_equals_jax_exactly(k, stride, dilation, h, w, cout):
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models import qops as jq
    from neuralbarkcalculator_tpu_torch.models import qops as tq

    rng = np.random.default_rng(k * 100 + dilation)
    cin = 16
    x = rng.integers(-127, 128, (2, h, w, cin), dtype=np.int8)
    kern = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    want = np.asarray(jq.qconv(jnp.asarray(x), jnp.asarray(kern), stride,
                               dilation))
    conv = tq.QConv(cin, cout, k, stride, dilation)
    conv.load_state_dict({"q": _port_state({"c_q": kern})["c.q"],
                          "m": torch.ones(cout), "b": torch.zeros(cout)})
    assert conv.q.shape == (-(-cout // 8) * 8, k * k * cin)
    got = conv.acc(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- calibration

@pytest.fixture(scope="module", params=["fcn", "deeplab"])
def calibrated(request):
    """(head kind, JAX folded model + variables, JAX stats, JAX quantized
    variables, the port's folded model carrying the JAX folded weights,
    calibration batch) of the tiny model, calibrated by the JAX package."""
    from neuralbarkcalculator_tpu.models.fold import fold_model as jfold
    from neuralbarkcalculator_tpu.models import quantize as jq
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.fold import fold_model

    kind = request.param
    jm = tiny_jax_model() if kind == "fcn" else tiny_deeplab_jax_model()
    tm = tiny_torch_model() if kind == "fcn" else tiny_deeplab_torch_model()
    fm, fv = jfold(jm, tiny_variables(seed=3, model=jm))
    fv = {"params": {k: v for k, v in fv["params"].items()}}
    x = _images(5)
    stats = jq.calibrate(fm, fv, [x])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qv = jq.quantize_variables(fv, stats, (1, 1, 1, 1), kind)
    port = fold_model(tm)
    port.load_state_dict(variables_to_state_dict(fv))
    return kind, fm, fv, stats, qv, port, x


def test_calibrate_matches_jax(calibrated):
    from neuralbarkcalculator_tpu_torch.models.quantize import calibrate

    _, _, _, stats, _, port, x = calibrated
    got = calibrate(port, [torch.from_numpy(x)])
    assert set(got) == set(stats)
    for key, v in stats.items():
        assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-30), key


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_quantize_variables_bit_equal_jax(calibrated):
    from neuralbarkcalculator_tpu.models import quantize as jq
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        quantize_variables)

    kind, _, fv, stats, qv, port, _ = calibrated
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # counted below
        got = dict(_leaves(quantize_variables(port.state_dict(), stats,
                                              (1, 1, 1, 1), kind)["params"]))
    want = dict(_leaves(qv["params"]))
    assert set(got) == set(want)
    for key, v in want.items():
        v = np.asarray(v)
        assert got[key].dtype == v.dtype, key
        np.testing.assert_array_equal(got[key], v, err_msg=str(key))

    # the q_ds overflow warning fires where JAX's does: every downsample
    # branch pushed past its clip range, then none
    for scale in (1e3, 0.0):
        boosted = {k: (v * scale if k[-1] == "q_ds" else v)
                   for k, v in stats.items()}
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jq.quantize_variables(fv, boosted, (1, 1, 1, 1), kind)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            quantize_variables(port.state_dict(), boosted, (1, 1, 1, 1),
                               kind)
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        assert len(tw) == (4 if scale else 0)


# ------------------------------------------------ blocks and heads, int8

def _random_qparams(tree, rng) -> dict:
    """Random int8 parameters of a JAX quantized module's param tree: int8
    weights, epilogue multipliers that keep the int8 outputs inside their
    range, small offsets, float pooled-branch weights."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_qparams(v, rng)
    for k, v in tree.items():
        if isinstance(v, dict):
            continue
        shape = np.shape(v)
        if k.endswith("_q"):
            out[k] = rng.integers(-127, 128, shape, dtype=np.int8)
            fan_in = int(np.prod(shape[:3]))
            out[k[:-2] + "_m"] = (rng.uniform(0.5, 1.5, shape[3])
                                  * 30.0 / (np.sqrt(fan_in) * 5300)
                                  ).astype(np.float32)
            out[k[:-2] + "_b"] = rng.normal(0, 5, shape[3]).astype(
                np.float32)
        elif k == "s_ratio":
            out[k] = np.float32(0.6)
        elif k == "pool_conv_kernel":
            out[k] = rng.normal(0, 0.05, shape).astype(np.float32)
        elif k == "pool_conv_bias":
            out[k] = rng.normal(0, 0.5, shape).astype(np.float32)
        elif k == "s_in":
            out[k] = np.float32(0.02)
        elif k == "inv_s_cat":
            out[k] = np.float32(12.0)
    return out


@pytest.mark.parametrize("planes,stride,dilation,downsample,cin", [
    (64, 1, 1, True, 64),     # layer1's first block
    (64, 1, 1, False, 256),   # a later block: x_q * s_ratio
    (128, 2, 1, True, 256),   # layer2's strided first block
    (256, 1, 2, False, 1024),
    (512, 1, 4, False, 2048),
])
def test_quantized_bottleneck_bit_equal_jax(planes, stride, dilation,
                                            downsample, cin):
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.resnet import Bottleneck
    from neuralbarkcalculator_tpu_torch.models.resnet import (
        QuantizedBottleneck)

    rng = np.random.default_rng(planes + stride + dilation)
    x = rng.integers(0, 128, (2, 12, 10, cin), dtype=np.int8)
    valid_h = np.array([12, 7], np.int32)
    jblock = Bottleneck(planes=planes, stride=stride, dilation=dilation,
                        has_downsample=downsample, quantized=True)
    template = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _random_qparams(template["params"], rng)
    block = QuantizedBottleneck(cin, planes, stride, dilation, downsample)
    block.load_state_dict(_port_state(params))
    for vh in (None, valid_h):
        want = np.asarray(jblock.apply(
            {"params": params}, jnp.asarray(x),
            valid_h=None if vh is None else jnp.asarray(vh)))
        with torch.inference_mode():
            got = block(torch.from_numpy(x), None if vh is None
                        else torch.from_numpy(vh)).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)


def _jax_pooled(params, x, valid_h):
    """The JAX ASPP's pooled branch (heads.py ASPP._quantized_forward),
    as jnp ops outside the module."""
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models import qops as jq
    from neuralbarkcalculator_tpu.models.resnet import apply_row_mask

    p = params["aspp"]
    xq = apply_row_mask(jnp.asarray(x), None if valid_h is None
                        else jnp.asarray(valid_h))
    sums = jnp.sum(xq.astype(jnp.int32), axis=(1, 2))
    denom = (jnp.float32(x.shape[1] * x.shape[2]) if valid_h is None
             else (jnp.asarray(valid_h).astype(jnp.float32)
                   * x.shape[2])[:, None])
    pooled = sums.astype(jnp.float32) * p["s_in"] / denom
    pooled = pooled @ p["pool_conv_kernel"] + p["pool_conv_bias"]
    return np.asarray(jq.quantize_act(jnp.maximum(pooled, 0),
                                      p["inv_s_cat"]))


@pytest.mark.parametrize("kind", ["fcn", "deeplab"])
def test_quantized_heads_bit_equal_jax(kind):
    import jax
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.heads import DeepLabHead, FCNHead
    from neuralbarkcalculator_tpu_torch.models.heads import (
        QuantizedDeepLabHead, QuantizedFCNHead)

    rng = np.random.default_rng(7)
    x = rng.integers(0, 128, (2, 9, 8, 2048), dtype=np.int8)
    valid_h = np.array([9, 5], np.int32)
    jhead = (FCNHead(3, quantized=True) if kind == "fcn"
             else DeepLabHead(3, quantized=True))
    template = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _random_qparams(template["params"], rng)
    head = (QuantizedFCNHead(2048, 3) if kind == "fcn"
            else QuantizedDeepLabHead(2048, 3))
    head.load_state_dict(_port_state(params))
    for vh in (None, valid_h):
        want = np.asarray(jhead.apply(
            {"params": params}, jnp.asarray(x),
            valid_h=None if vh is None else jnp.asarray(vh)))
        tvh = None if vh is None else torch.from_numpy(vh)
        with torch.inference_mode():
            if kind == "deeplab":
                # the float32 pooled product may move pooled_q by 1 LSB
                pooled = head.aspp.pooled(
                    _mask(torch.from_numpy(x), tvh), tvh).numpy()
                jpooled = _jax_pooled(params, x, vh)
                assert np.abs(pooled.astype(int) - jpooled).max() <= 1
                head.aspp.pooled = (
                    lambda *a, p=jpooled: torch.from_numpy(p.copy()))
            got = head(torch.from_numpy(x), tvh).numpy()
            if kind == "deeplab":
                del head.aspp.pooled
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _mask(x, vh):
    from neuralbarkcalculator_tpu_torch.models.qops import mask_rows
    return mask_rows(x, vh)


# ------------------------------------------------------- whole models

def _jax_quantized(fm):
    return fm.clone(backbone=fm.backbone.clone(quantized=True),
                    classifier=fm.classifier.clone(quantized=True))


def _port_quantized(kind, qv):
    from neuralbarkcalculator_tpu_torch.models.convert import (
        quantized_variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        quantized_twin)

    tm = tiny_torch_model() if kind == "fcn" else tiny_deeplab_torch_model()
    qm = quantized_twin(tm)
    qm.load_state_dict(quantized_variables_to_state_dict(qv))
    return qm.eval()


def test_whole_model_with_jax_params(calibrated):
    """JAX's quantized params carried across: from one post-stem int8
    tensor, the port's int8 blocks and head equal JAX's modules bit for
    bit; head_logits with the float stem within HEAD_LOGITS_REL_L2."""
    import jax.numpy as jnp
    from neuralbarkcalculator_tpu.models.heads import DeepLabHead, FCNHead
    from neuralbarkcalculator_tpu.models.resnet import Bottleneck
    from neuralbarkcalculator_tpu.models.segmentation import (
        SegmentationModel)

    kind, fm, _, _, qv, _, x = calibrated
    qm = _port_quantized(kind, qv)
    want = np.asarray(_jax_quantized(fm).apply(
        qv, jnp.asarray(x), train=False,
        method=SegmentationModel.head_logits))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = qm.head_logits(xt).numpy()
        x_q = qm.backbone.stem(xt)
        feat = qm.backbone.blocks(x_q)
        logits = qm.classifier(feat).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert got.shape == want.shape and rel <= HEAD_LOGITS_REL_L2, rel

    jx = jnp.asarray(x_q.numpy())
    for stage, layer in enumerate((qm.backbone.layer1, qm.backbone.layer2,
                                   qm.backbone.layer3, qm.backbone.layer4)):
        for i, block in enumerate(layer):
            jblock = Bottleneck(
                planes=block.conv1.cout, stride=block.conv2.stride,
                dilation=block.conv2.dilation,
                has_downsample=block.downsample is not None,
                quantized=True)
            jx = jblock.apply({"params": qv["params"]["backbone"][
                f"layer{stage + 1}_{i}"]}, jx)
    np.testing.assert_array_equal(feat.numpy(), np.asarray(jx))
    jhead = (FCNHead(3, quantized=True) if kind == "fcn"
             else DeepLabHead(3, quantized=True))
    head_params = qv["params"]["classifier"]
    if kind == "deeplab":
        pooled = qm.classifier.aspp.pooled(feat).numpy()
        jpooled = _jax_pooled(head_params, feat.numpy(), None)
        assert np.abs(pooled.astype(int) - jpooled).max() <= 1
        qm.classifier.aspp.pooled = (
            lambda *a: torch.from_numpy(jpooled.copy()))
        with torch.inference_mode():
            logits = qm.classifier(feat).numpy()
    np.testing.assert_array_equal(
        logits, np.asarray(jhead.apply({"params": head_params}, jx)))


@pytest.mark.parametrize("kind", ["fcn", "deeplab"])
def test_ragged_batch_equals_per_image_bitwise(kind):
    """quantize_model on the port's tiny model; a padded batch (rows past
    48 zero, valid_h [64, 48]) equals the 48-row image run alone, bit for
    bit (the int8 sums are exact, the masks keep padded rows zero, the
    pooled branch divides an exact int32 sum by the true pixel count)."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        load_state_dict_into, variables_to_state_dict)
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        quantize_model)

    jm = tiny_jax_model() if kind == "fcn" else tiny_deeplab_jax_model()
    model = tiny_torch_model() if kind == "fcn" \
        else tiny_deeplab_torch_model()
    load_state_dict_into(model, variables_to_state_dict(
        tiny_variables(seed=4, model=jm)))
    x = _images(6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qm = quantize_model(model, [torch.from_numpy(x)])
    x[1, 48:] = 0.0
    with torch.inference_mode():
        pad = qm.head_logits(torch.from_numpy(x),
                             torch.tensor([64, 48], dtype=torch.int32))
        solo = qm.head_logits(torch.from_numpy(x[1:, :48]))
        full = qm(torch.from_numpy(x[:1]))
    fh = qm.backbone.valid_feature_height(48)
    assert torch.equal(pad[1, :fh], solo[0])
    assert full.shape == (1, 64, 64, 3) and full.dtype == torch.float32


def test_rejections():
    from neuralbarkcalculator_tpu_torch.models.quantize import (
        quantize_model, quantized_twin)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        MODEL_FACTORIES)

    x = torch.from_numpy(_images(8, n=1))
    with pytest.raises(ValueError, match="int8"):
        quantize_model(MODEL_FACTORIES["fcn_efficientnet_b0"]().eval(), [x])
    qm = quantized_twin(tiny_torch_model())
    with pytest.raises(ValueError, match="inference-only"):
        qm.train().head_logits(x)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cout", [(1, 3), (16, 3), (17, 8),
                                       (8192, 3), (8192, 256)])
def test_int8_gemm_on_card_equals_cpu(rows, cout):
    """On the card torch._int_mm needs more than 16 rows and N a multiple
    of 8: the classifier's N = 3 (padded) and row counts at the limit give
    the CPU's exact sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuBLAS's int8 GEMM has no CPU "
                    "mode (chip_smoke.py runs the int8 path on the card)")
    from neuralbarkcalculator_tpu_torch.models.qops import QConv

    rng = np.random.default_rng(rows)
    cin = 256
    x = rng.integers(0, 128, (1, 1, rows, cin), dtype=np.int8)
    conv = QConv(cin, cout)
    conv.load_state_dict({"q": _port_state({"c_q": rng.integers(
        -127, 128, (1, 1, cin, cout), dtype=np.int8)})["c.q"],
        "m": torch.ones(cout), "b": torch.zeros(cout)})
    want = conv.acc(torch.from_numpy(x))
    got = conv.cuda().acc(torch.from_numpy(x).cuda())
    assert torch.equal(got.cpu(), want)
