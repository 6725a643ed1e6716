"""PyTorch / CUDA port of the bark calculator, for one NVIDIA H100.

It sits beside the JAX package ``neuralbarkcalculator_tpu`` (the reference
it is held against), imports nothing from it and never imports jax. This
slice covers folder prediction with ``fcn_resnet50``: host preprocess,
the ragged batched engine, the hand-written ``upsample_argmax`` CUDA
kernel, the native postprocess and the reference's artifacts.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); with no card and no such request they
raise.

    from neuralbarkcalculator_tpu_torch.pipeline.predict import (
        NeuralBarkCalculator)
    NeuralBarkCalculator("best_model.pt").predict(root)
"""
__version__ = "0.1.0"
