"""The FLOP and byte counters against hand counts."""
import torch

from portbench import reference
from portbench.lib import flops

FCN, DEEPLAB = {"model": "fcn_resnet50"}, {"model": "deeplabv3_resnet101"}


def test_stem_conv_flops_by_hand():
    counts = []
    ops = reference.Ops(on_conv=lambda x, w, y: counts.append(
        2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]))
    x = torch.empty((1, 3, 960, 1024), device="meta")
    w = torch.empty((64, 3, 7, 7), device="meta")
    ops.c(x, w, None, 2, 3)
    assert counts == [2 * 64 * 480 * 512 * 3 * 7 * 7]


def test_model_flops_scale_with_the_image():
    a = flops.model_flops(FCN, 512, 512)
    b = flops.model_flops(FCN, 1024, 1024)
    assert abs(b / a - 4.0) < 0.01
    # the classifier's 1x1 conv at stride 8: 2 x 3 x 512 x (128 x 128)
    assert b > 2 * 3 * 512 * 128 * 128


def test_train_step_is_three_forwards_less_the_stem_input_gradient():
    fwd = flops._product_flops("model", "deeplabv3_resnet101", 5, 512, 512,
                               True)
    assert flops.train_step_flops(DEEPLAB, 5, 512) == 3 * sum(fwd) - fwd[0]


def test_upsample_argmax_bytes_by_hand():
    # the engine's launch: 8 images of 1024 x 1024, logits at stride 8
    got = flops.upsample_argmax_bytes(8, 128, 128, 1024, 1024)
    logits = 8 * 128 * 128 * 3 * 4
    rows = 8 * 1024 * 128 * 4
    cols = 128 * 1024 * 4 + 2 * 1024 * 4
    out = 8 * 1024 * 1024
    assert got == logits + rows + cols + out == 14_688_256
