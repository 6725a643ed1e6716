"""PyTorch port: the EfficientNet backbones and the engine's exact-height
path, against the JAX package.

Weights come from the port's side (``torch_port_common.zoo_model``, drawn
with numpy from a seed), with BN statistics calibrated on blob images
(``calibrate_bn``): otherwise a random EfficientNet's logits hardly depend
on the image at these sizes. They cross to the JAX
package through its own converter (``torch_state_dict_to_variables``, the
reference checkpoint format), so the port's names are held by the JAX
package's. Tolerances: head logits within 1e-4 of the largest |logit|
(the calibrated network amplifies rounding, and the two frameworks sum in
other orders: measured ~1.5e-5 of it); the engine's maps equal JAX's away
from near ties and the per-image runs bit for bit.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (blob_image, calibrate_bn, normalized,
                               zoo_model)

WIDTH = 64
# head logits of the two packages agree within this share of the largest
# |logit| (measured ~1.5e-5 on these weights)
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_variables(model, name):
    from neuralbarkcalculator_tpu.models.convert import (
        torch_state_dict_to_variables)
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        efficientnet_variant_of)

    return torch_state_dict_to_variables(
        {k: v.numpy() for k, v in model.state_dict().items()},
        head="deeplab" if name.startswith("deeplab") else "fcn",
        efficientnet_variant=efficientnet_variant_of(name))


@pytest.fixture(scope="module")
def b0():
    return calibrate_bn(zoo_model("fcn_efficientnet_b0", seed=0), seed=0)


def test_tables_match_jax():
    """round_filters / round_repeats, the block tables and the feature
    channels of B0..B7 equal the JAX package's, without running a net."""
    from neuralbarkcalculator_tpu.models import efficientnet as je
    from neuralbarkcalculator_tpu.models.convert import (
        _efficientnet_block_table)
    from neuralbarkcalculator_tpu_torch.models import efficientnet as te
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        deeplabv3_efficientnet)

    assert te.SCALING == je.SCALING
    assert te.BASE_BLOCKS == je.BASE_BLOCKS
    assert te.EFFICIENTNET_INPLANES == je.EFFICIENTNET_INPLANES
    for filters in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for width, depth in je.SCALING:
            assert te.round_filters(filters, width) == \
                je.round_filters(filters, width)
            assert te.round_repeats(filters % 5, depth) == \
                je.round_repeats(filters % 5, depth)
    for n in range(8):
        assert [f"block{s}_{i}" for s, i in te.block_table(n)] == \
            _efficientnet_block_table(n)
        with torch.device("meta"):
            model = deeplabv3_efficientnet(n)
        assert model.backbone.out_channels == je.EFFICIENTNET_INPLANES[n]
        assert model.classifier.in_channels == je.EFFICIENTNET_INPLANES[n]
        assert len(model.backbone.model._blocks) == len(te.block_table(n))


@pytest.mark.parametrize("name", ["fcn_efficientnet_b0",
                                  "deeplabv3_efficientnet_b0"])
def test_variables_map_to_the_port(name):
    """JAX variables -> variables_to_state_dict: every key of the model's
    state dict, the same values as the JAX package's inverse converter
    gives; the variant may be given by number or by model name."""
    from neuralbarkcalculator_tpu_torch.models.convert import (
        variables_to_state_dict)

    model = zoo_model(name, seed=1)
    variables = _jax_variables(model, name)
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    for variant in (0, name):
        got = variables_to_state_dict(variables, variant)
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="variant"):
        variables_to_state_dict(variables)


@pytest.mark.parametrize("name", ["fcn_efficientnet_b0",
                                  "deeplabv3_efficientnet_b0"])
@pytest.mark.parametrize("h,w", [(47, 61), (50, 64), (63, 33)])
def test_head_logits_match_jax(name, h, w, b0):
    """TF-SAME on odd and even sizes: the feature shape and the logits
    equal the JAX package's."""
    import jax
    from neuralbarkcalculator_tpu.models.segmentation import (
        MODEL_FACTORIES, SegmentationModel)

    model = (b0 if name == "fcn_efficientnet_b0"
             else calibrate_bn(zoo_model(name, seed=0), seed=0))
    jax_model = MODEL_FACTORIES[name]()
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: jax_model.apply(
        v, x, train=False, method=SegmentationModel.head_logits))(
            _jax_variables(model, name), x))
    with torch.inference_mode():
        got = model.head_logits(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-h // 32), -(-w // 32), 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_same_padding_matches_flax():
    import jax

    from neuralbarkcalculator_tpu_torch.models.efficientnet import (
        same_padding)

    for n in (1, 2, 15, 32, 33, 47, 50, 61, 63, 64):
        for kernel in (1, 3, 5):
            for stride in (1, 2):
                assert same_padding(n, kernel, stride) == tuple(
                    jax.lax.padtype_to_pads((n,), (kernel,), (stride,),
                                            "SAME")[0])


def test_train_mode_and_ragged_raise(b0):
    """Train mode needs the step's seed (its stochastic depth) and an
    unfolded model; ragged batches raise."""
    import copy

    from neuralbarkcalculator_tpu_torch.models.fold import fold_model

    with pytest.raises(ValueError, match="dropout_seed"):
        copy.deepcopy(b0).train().head_logits(torch.zeros(2, 32, 32, 3))
    with pytest.raises(ValueError, match="inference-only"):
        fold_model(b0).train().head_logits(torch.zeros(2, 32, 32, 3),
                                           dropout_seed=1)
    with pytest.raises(NotImplementedError, match="ResNet"):
        b0.head_logits(torch.zeros(1, 32, 32, 3),
                       valid_h=torch.tensor([32]))
    assert b0.backbone.supports_ragged is False
    assert (b0.backbone.feature_stride, b0.backbone.bn_eps) == (32, 1e-3)


def _checkpoint(model, path):
    """``model``'s weights as a reference best_model.pt, with the unused
    ImageNet ``_fc`` a reference EfficientNet checkpoint carries."""
    state = dict(model.state_dict())
    state["backbone.model._fc.weight"] = torch.ones(1000, 1280)
    state["backbone.model._fc.bias"] = torch.zeros(1000)
    torch.save(state, path)
    return str(path)


def _items(heights, seed):
    from neuralbarkcalculator_tpu_torch.pipeline.preprocess import (
        ProcessedImage)

    rng = np.random.default_rng(seed)
    return [ProcessedImage(blob_image(rng, h, WIDTH), f"img{i}.png", "sapin")
            for i, h in enumerate(heights)]


def _near_ties(engine, image) -> np.ndarray:
    """[h, w] bool: pixels whose top-2 logit margin in a float32 forward
    of the engine's folded model is under LOGIT_TOL of the largest
    |logit|, where the two frameworks' sums may order the classes
    differently."""
    with torch.inference_mode():
        logits = engine.model(torch.from_numpy(normalized(image[None])))[0]
    top2 = logits.topk(2).values
    return (top2[..., 0] - top2[..., 1] < LOGIT_TOL * logits.abs().max()
            ).numpy()


def _port_engine(pt, **config):
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    return NeuralBarkCalculator(
        pt, model_name="fcn_efficientnet_b0", device="cpu",
        config=PredictConfig(model_path=pt, use_bfloat16=False, **config))


@pytest.fixture(scope="module")
def b0_checkpoint(b0, tmp_path_factory):
    return _checkpoint(b0, tmp_path_factory.mktemp("effnet") / "b0.pt")


def test_engine_exact_heights_equal_jax_and_per_image(b0_checkpoint):
    """Mixed heights through the exact-height path: the JAX engine's maps
    away from near ties, and the port's own per-image runs bit for bit;
    one launch shape per distinct (height, batch)."""
    from neuralbarkcalculator_tpu.config import PredictConfig as JaxConfig
    from neuralbarkcalculator_tpu.parallel.mesh import make_mesh
    from neuralbarkcalculator_tpu.pipeline.predict import (
        NeuralBarkCalculator as JaxEngine)

    pt = b0_checkpoint
    items = _items([64, 48, 64, 48, 40], seed=3)
    port = _port_engine(pt, batch_size=2)
    assert port._exact_heights and not port._bucketed_exact
    jax_engine = JaxEngine(
        pt, mesh=make_mesh(n_data=1), model_name="fcn_efficientnet_b0",
        config=JaxConfig(model_path=pt, use_bfloat16=False, batch_size=2,
                         use_pallas=True, pallas_interpret=True))
    want = {it.fname: m for it, m in jax_engine.predict_images(items)}
    got = {it.fname: m for it, m in port.predict_images(items)}
    classes = set()
    ties = 0
    for it in items:
        assert got[it.fname].shape == it.image.shape[:2]
        away = ~_near_ties(port, it.image)
        ties += int((~away).sum())
        np.testing.assert_array_equal(got[it.fname][away],
                                      want[it.fname][away])
        classes |= set(np.unique(got[it.fname]).tolist())
    assert len(classes) >= 2
    assert ties < 1e-3 * sum(it.image.shape[0] * WIDTH for it in items)
    # (64, 2), (48, 2), (40, 1)
    assert port.cache_stats()["launch_shapes"] == 3
    for it in items:
        (_, alone), = port.predict_images([it])
        np.testing.assert_array_equal(alone, got[it.fname])


def test_bucketed_heights(b0_checkpoint):
    """effnet_bucket_heights: heights on the bucket give the exact path's
    bits; mixed heights in one bucket share one launch shape and come back
    at their own heights; a bucket off the feature stride raises."""
    pt = b0_checkpoint
    on_bucket = _items([64, 64], seed=4)
    exact = {it.fname: m for it, m in
             _port_engine(pt, batch_size=2).predict_images(on_bucket)}
    bucketed = _port_engine(pt, batch_size=4, height_bucket=64,
                            effnet_bucket_heights=True)
    assert bucketed._bucketed_exact
    for it, m in bucketed.predict_images(on_bucket):
        np.testing.assert_array_equal(m, exact[it.fname])
    mixed = _items([48, 40, 64, 33], seed=5)
    before = bucketed.cache_stats()["launch_shapes"]
    for it, m in bucketed.predict_images(mixed):
        assert m.shape == it.image.shape[:2]
    assert bucketed.cache_stats()["launch_shapes"] == before + 1
    with pytest.raises(ValueError, match="feature stride"):
        _port_engine(pt, height_bucket=48, effnet_bucket_heights=True)


def test_edge_rows_padded_and_ignored_by_resnet(b0_checkpoint, tmp_path):
    """The bucketed pad rows replicate the last row; a ResNet engine keeps
    zero pad rows and its ragged path with the option set."""
    from neuralbarkcalculator_tpu_torch.models.segmentation import (
        fcn_resnet50)

    bucketed = _port_engine(b0_checkpoint, height_bucket=64,
                            effnet_bucket_heights=True)
    item, = _items([40], seed=6)
    buf = bucketed._pad_group([item], 64, 2)
    np.testing.assert_array_equal(buf[0, 40:], np.broadcast_to(
        item.image[39], (24, WIDTH, 3)))
    assert not buf[1].any()  # the ladder's dummy stays zero
    torch.manual_seed(0)
    pt = str(tmp_path / "r50.pt")
    torch.save(fcn_resnet50().state_dict(), pt)
    from neuralbarkcalculator_tpu_torch.config import PredictConfig
    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)

    resnet = NeuralBarkCalculator(pt, device="cpu", config=PredictConfig(
        model_path=pt, height_bucket=48, effnet_bucket_heights=True))
    assert not resnet._exact_heights and not resnet._bucketed_exact
    assert not resnet._pad_group([item], 64, 1)[0, 40:].any()
